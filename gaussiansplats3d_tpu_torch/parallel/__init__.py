"""Training on one GPU: parameters, the train step, densify/prune.  The
multi-GPU mesh and sharded render are not ported yet."""
