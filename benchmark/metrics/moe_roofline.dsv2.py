"""moe_roofline.dsv2: the routed experts' least time over the device time of their grouped products (the kernels whose name holds GroupProblemShape: CUTLASS's grouped GEMM behind torch._grouped_mm, three a MoE layer), in %, over the traced batches. The least time of a batch is the sum over the MoE layers of the larger of the routed FLOPs of its real tokens at 989 TFLOP/s and all routed experts' bf16 weight bytes at 3.35 TB/s (every expert gets tokens at B=256: the moe.idle_experts counter reads 0)."""
from benchmark import costs, encoders
from benchmark.readers import kernel_roofline


def least_s(obs, idx):
    enc = obs["cfg"]["encoder"]
    plugin = encoders.load(enc)
    tokens = sum(len(obs["token_ids"][i]) for i in idx)
    layer = max(costs.seconds_for_bf16_flops(plugin.routed_flops(enc, tokens)),
                costs.seconds_for_bytes(plugin.expert_bytes(enc)))
    return (enc["num_hidden_layers"] - enc["first_k_dense_replace"]) * layer


def read(obs):
    return kernel_roofline(obs, "GroupProblemShape", least_s)
