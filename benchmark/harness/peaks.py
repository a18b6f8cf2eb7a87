"""Published peaks of one NVIDIA H100 SXM (dense, no sparsity, at the 700 W
limit), and the least time a piece of work needs on it."""
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12        # float32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12    # bf16 / fp16 tensor cores, dense


def least_seconds(bytes_moved: float, ops: float, ops_per_s: float = F32_OPS_PER_S) -> float:
    """The larger of the bytes over HBM bandwidth and the operations over
    the compute peak."""
    return max(bytes_moved / HBM_BYTES_PER_S, ops / ops_per_s)


def auction_work(problems: int, n: int):
    """(bytes, operations) of auction launches from their inputs alone: each
    (n, n) float32 benefit read once, the n int32 assignments written once,
    n^2 operations a problem."""
    return problems * (4.0 * n * n + 4.0 * n), problems * float(n * n)


def nms_work(boxes: int, kept_later_pairs: float):
    """(bytes, operations) of greedy NMS: 16 B of box and 1 B of validity in,
    1 B of keep-mask out a box; 14 operations for the IoU test of each pair
    (kept box, later valid box)."""
    return 18.0 * boxes, 14.0 * kept_later_pairs
