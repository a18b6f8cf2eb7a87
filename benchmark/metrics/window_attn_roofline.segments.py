"""The Swin window-attention kernel's share of its roofline, in %: the least
time its launches need over their device time.

The work is counted from the configuration alone: the letterboxed image
size, Swin-T's widths as the configuration's reference holds them
(``benchmark/reference_swin/model.py SWIN_T``) and the images the detector
ran, the program's counters ``frames_real`` + ``frames_pad``. A block's launch over
a map padded to multiples of the window, T padded tokens of C channels,
reads q, k and v once and writes the output once in bf16 (8 C bytes a
token) and reads the bias table (169 x heads float32); it needs 196 C
operations a token (scores and the weighted sum: 2 x 49 x C multiply-adds).
Its least time is the larger of the bytes over 3.35 TB/s and the operations
over the bf16 tensor-core peak, 989 TFLOP/s. The reader cross-checks the
program's counters ``window_attn_launches`` against the trace's kernel count
and ``window_attn_tokens`` against the padded tokens counted here, and
reads nothing when either disagrees."""
import sys

from benchmark.reference_swin.model import SWIN_T

PATCH, EMBED, WINDOW = SWIN_T["patch"], SWIN_T["embed_dim"], SWIN_T["window"]
DEPTHS, HEADS = SWIN_T["depths"], SWIN_T["heads"]
BYTES_PER_ELEMENT = 2     # bf16 q, k, v and output


def _pad(n: int, m: int) -> int:
    return -(-n // m) * m


def launches_per_image(image_hw):
    """[(padded tokens, channels, heads)] of each block's launch for one
    image of ``image_hw`` (H, W)."""
    h, w = -(-image_hw[0] // PATCH), -(-image_hw[1] // PATCH)
    out = []
    for i, (depth, heads) in enumerate(zip(DEPTHS, HEADS)):
        tokens = _pad(h, WINDOW) * _pad(w, WINDOW)
        out += [(tokens, EMBED * 2 ** i, heads)] * depth
        h, w = (h + 1) // 2, (w + 1) // 2
    return out


def work(tokens: int, c: int, heads: int, launches: int = 1):
    """(bytes, operations) of ``launches`` launches of one block covering
    ``tokens`` padded tokens in all."""
    table = (2 * WINDOW - 1) ** 2 * heads * 4
    n = WINDOW * WINDOW
    return 4 * c * BYTES_PER_ELEMENT * tokens + table * launches, 2 * 2 * n * c * tokens


def _counters():
    from waymo_2d_tracking_tpu_torch.utils import profiling
    counters = getattr(profiling, "counters", None)
    return counters() if counters is not None else {}


def read(view):
    runs = view.trace.kernels("window_attention")
    busy = sum(e - s for s, e, _ in runs) * 1e-6
    c = _counters()
    images = c.get("frames_real", 0) + c.get("frames_pad", 0)
    if not runs or busy <= 0 or not images:
        return None
    per_image = launches_per_image(view.cfg["detector"]["image_size"])
    tokens = images * sum(t for t, _, _ in per_image)
    if c.get("window_attn_launches") != len(runs) or c.get("window_attn_tokens") != tokens:
        print(f"window_attn_roofline: the counters (launches {c.get('window_attn_launches')}, "
              f"tokens {c.get('window_attn_tokens')}) disagree with the trace's {len(runs)} "
              f"kernels and the {tokens} tokens of {images} images", file=sys.stderr)
        return None
    launches = len(runs) // len(per_image)      # of each block
    least = sum(view.peaks.least_seconds(*work(t * images, ch, heads, launches),
                                         view.peaks.BF16_FLOPS_PER_S)
                for t, ch, heads in per_image)
    return 100.0 * least / busy
