"""expert_load.dsv2: the window's mean of the moe.expert_load observations, one a forward: the busiest routed expert's tokens over the mean expert's, averaged over the MoE layers (1 is an even spread)."""
from benchmark.leaf_spans import mean_ms


def read(obs):
    return mean_ms(obs, "moe.expert_load")
