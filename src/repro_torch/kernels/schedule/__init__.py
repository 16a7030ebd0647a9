"""HarMoEny's Alg. 2 rebalance on the device (the JAX scheduler's while loop)."""
