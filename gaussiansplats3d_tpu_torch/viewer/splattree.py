"""Octree over splat centers — SplatTree parity
(src/splattree/SplatTree.js:132-278 build algorithm, :443 visitLeaves);
counterpart of the JAX package's ``viewer/splattree.py``.

The tiled renderer does not need this structure (tile binning on-chip
supersedes the octree cull, SURVEY.md §2.3), but it remains useful for
host-side spatial queries: frustum/box culling for streaming decisions,
level-of-detail grouping, nearest-region lookups.  Built vectorized with
NumPy rather than the reference's recursive worker.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np

from ..core.types import SplatData

DEFAULT_MAX_DEPTH = 8            # SplatMesh.js:236
DEFAULT_MAX_CENTERS_PER_NODE = 1000


@dataclasses.dataclass
class SplatTreeNode:
    min: np.ndarray                  # [3]
    max: np.ndarray                  # [3]
    depth: int
    indices: Optional[np.ndarray]    # splat indices (leaves only)
    children: List["SplatTreeNode"]

    @property
    def is_leaf(self) -> bool:
        return not self.children

    @property
    def center(self) -> np.ndarray:
        return 0.5 * (self.min + self.max)


class SplatTree:
    def __init__(self, max_depth: int = DEFAULT_MAX_DEPTH,
                 max_centers_per_node: int = DEFAULT_MAX_CENTERS_PER_NODE):
        self.max_depth = max_depth
        self.max_centers_per_node = max_centers_per_node
        self.root: Optional[SplatTreeNode] = None
        self.nodes_with_indexes: List[SplatTreeNode] = []

    def process_splats(self, splats: SplatData) -> "SplatTree":
        centers = splats.means.detach().cpu().numpy().astype(np.float32)
        mn = centers.min(axis=0)
        mx = centers.max(axis=0) + 1e-5
        self.root = self._build(centers, np.arange(len(centers)), mn, mx, 0)
        self.nodes_with_indexes = []
        self.visit_leaves(lambda n: self.nodes_with_indexes.append(n)
                          if n.indices is not None and len(n.indices)
                          else None)
        return self

    def _build(self, centers, indices, mn, mx, depth) -> SplatTreeNode:
        if depth >= self.max_depth or len(indices) <= \
                self.max_centers_per_node:
            return SplatTreeNode(min=mn, max=mx, depth=depth,
                                 indices=indices, children=[])
        mid = 0.5 * (mn + mx)
        pts = centers[indices]
        octant = ((pts[:, 0] >= mid[0]).astype(int)
                  | ((pts[:, 1] >= mid[1]).astype(int) << 1)
                  | ((pts[:, 2] >= mid[2]).astype(int) << 2))
        children = []
        for o in range(8):
            sel = indices[octant == o]
            cmn = np.array([mid[i] if (o >> i) & 1 else mn[i]
                            for i in range(3)], np.float32)
            cmx = np.array([mx[i] if (o >> i) & 1 else mid[i]
                            for i in range(3)], np.float32)
            if len(sel) == 0:
                continue
            children.append(self._build(centers, sel, cmn, cmx, depth + 1))
        return SplatTreeNode(min=mn, max=mx, depth=depth, indices=None,
                             children=children)

    def visit_leaves(self, fn: Callable[[SplatTreeNode], None]) -> None:
        def walk(node):
            if node is None:
                return
            if node.is_leaf:
                fn(node)
            for c in node.children:
                walk(c)
        walk(self.root)

    def query_box(self, lo, hi) -> np.ndarray:
        """Splat indices whose leaf boxes intersect the AABB [lo, hi]."""
        lo = np.asarray(lo, np.float32)
        hi = np.asarray(hi, np.float32)
        out = []

        def walk(node):
            if (node.max < lo).any() or (node.min > hi).any():
                return
            if node.is_leaf:
                if node.indices is not None:
                    out.append(node.indices)
                return
            for c in node.children:
                walk(c)
        if self.root is not None:
            walk(self.root)
        return np.concatenate(out) if out else np.zeros((0,), np.int64)
