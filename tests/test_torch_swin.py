"""The Swin-T backbone (``models/swin.py``) and its window attention
(``ops/window_attention.py``) against the plain reference
``benchmark/reference_swin`` (the release's code order), on seeded random
weights in float32 on the CPU:

- the four stage outputs at sizes whose maps are and are not multiples of
  the window, with odd maps before a patch merging and an image that is not
  a multiple of the patch; the whole detector's head outputs and P3;
- the plain window path against full attention plus the bias, the shift
  mask against the release's ``img_mask`` construction, and a numpy model of
  ``csrc/window_attention.cu``'s index arithmetic (the shift folded into the
  gather, the region label from the window's position) against the plain
  path;
- the bias tables' init, every ResNet preset's init unchanged, int8 refused,
  the ``w2t/backbone`` span and the two counters;
- the autograd function that CUDA tensors take (the kernel forward, the
  plain path's gradients), with the plain path in the kernel's place.

Tolerances: the port and the reference run the same float32 operations, so
they agree to 1e-5 (absolute, on outputs of order 1); the numpy model sums
in float64, 1e-5.

The ``card`` tests hold the kernel to the plain path on the card:

    python -m pytest --noconftest -p no:cacheprovider -q -m card tests/test_torch_swin.py
"""
import math
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.reference_swin import model as ref_model  # noqa: E402
from waymo_2d_tracking_tpu_torch.config import DetectorConfig  # noqa: E402
from waymo_2d_tracking_tpu_torch.models import swin  # noqa: E402
from waymo_2d_tracking_tpu_torch.models.detector import _BACKBONES, Detector  # noqa: E402
from waymo_2d_tracking_tpu_torch.ops import window_attention as wa  # noqa: E402
from waymo_2d_tracking_tpu_torch.utils import profiling  # noqa: E402

torch.set_num_threads(1)

DET = dict(num_classes=3, image_size=[64, 96], backbone="swin_t", stem="s2d", fpn_channels=32,
           fpn_levels=[3, 4, 5, 6, 7], head_family="fcos", centernet_level=3, head_depth=1,
           head_channels=32, score_threshold=0.05, pre_nms_topk=64, topk_method="exact",
           nms_topk=128, nms_iou_threshold=0.6, max_detections=16, embed_dim=32,
           reid_channels=32, reid_multilevel=False, dtype="float32", quant="off",
           quant_scope="trunk")


def _port_cfg(**kw) -> DetectorConfig:
    d = dict(DET, **kw)
    return DetectorConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in d.items()})


@pytest.fixture(scope="module")
def pair():
    """(reference detector, port detector) holding the same weights."""
    ref = ref_model.Detector(DET).eval()
    ref_model.init_weights(ref, torch.Generator().manual_seed(19))
    prog = Detector(_port_cfg()).eval()
    prog.load_state_dict(ref.state_dict())
    return ref, prog


def _images(hw, n=2, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.rand((n,) + tuple(hw) + (3,), generator=g) * 255.0


# 64x96: stage maps 16x24 .. 2x3, none a multiple of 7; 72x104: odd maps
# (9x13, 5x7) before the merges; 66x98: padded to the patch first
@pytest.mark.parametrize("hw", [(64, 96), (72, 104), (66, 98)])
def test_backbone_stages_match_the_reference(pair, hw):
    ref, prog = pair
    x = _images(hw)
    with torch.no_grad():
        want, got = ref.backbone(x), prog.backbone(x)
    assert set(got) == {2, 3, 4, 5} and prog.backbone.out_channels == {2: 96, 3: 192, 4: 384,
                                                                        5: 768}
    for lvl in want:
        assert got[lvl].shape == want[lvl].shape
        torch.testing.assert_close(got[lvl], want[lvl], rtol=0, atol=1e-5)


def test_detector_heads_and_p3_match_the_reference(pair):
    ref, prog = pair
    x = _images(DET["image_size"], seed=1)
    with torch.no_grad():
        (h_ref, f_ref), (h_got, f_got) = ref(x), prog(x)
    for lvl in DET["fpn_levels"]:
        for a, b in zip(h_got[lvl], h_ref[lvl]):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(f_got[3], f_ref[3], rtol=0, atol=1e-5)


def _qkv(b, hp, wp, c, seed=0, dtype=torch.float32, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((b, hp, wp, 3 * c), generator=g).to(device=device, dtype=dtype)


def _table(heads, seed=1, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((169, heads), generator=g) * 0.5).to(device)


def test_plain_path_with_one_window_is_full_attention_plus_bias():
    heads, c = 2, 16
    qkv, table = _qkv(3, 7, 7, c), _table(heads)
    got = wa.window_attention_reference(qkv, table, heads, 7, 0)
    tok = qkv.reshape(3, 49, 3, heads, c // heads)
    q, k, v = tok[:, :, 0], tok[:, :, 1], tok[:, :, 2]                 # (B, N, heads, d)
    ys, xs = np.divmod(np.arange(49), 7)
    idx = (ys[:, None] - ys[None, :] + 6) * 13 + (xs[:, None] - xs[None, :] + 6)
    bias = table[torch.from_numpy(idx)]                                 # (N, N, heads)
    scores = torch.einsum("bihd,bjhd->bhij", q, k) / math.sqrt(c // heads)
    attn = torch.softmax(scores + bias.permute(2, 0, 1)[None], dim=-1)
    want = torch.einsum("bhij,bjhd->bihd", attn, v).reshape(3, 7, 7, c)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def _release_img_mask(hp, wp, ws, shift):
    """The release's construction (``BasicLayer.forward``), verbatim."""
    img_mask = torch.zeros((1, hp, wp, 1))
    h_slices = (slice(0, -ws), slice(-ws, -shift), slice(-shift, None))
    w_slices = (slice(0, -ws), slice(-ws, -shift), slice(-shift, None))
    cnt = 0
    for h in h_slices:
        for w in w_slices:
            img_mask[:, h, w, :] = cnt
            cnt += 1
    x = img_mask.view(1, hp // ws, ws, wp // ws, ws, 1)
    mask_windows = x.permute(0, 1, 3, 2, 4, 5).contiguous().view(-1, ws, ws, 1)
    mask_windows = mask_windows.view(-1, ws * ws)
    attn_mask = mask_windows.unsqueeze(1) - mask_windows.unsqueeze(2)
    return attn_mask.masked_fill(attn_mask != 0, float(-100.0)).masked_fill(attn_mask == 0,
                                                                           float(0.0))


def test_shift_mask_is_the_release_img_mask():
    got = wa.shift_mask(14, 14, 7, 3)
    want = _release_img_mask(14, 14, 7, 3)
    assert torch.equal(got, want)
    assert set(got.unique().tolist()) == {-100.0, 0.0}
    assert not got[0].any() and got[3].ne(0).sum() > 0     # window 0 holds one region


def _kernel_model(qkv, table, heads, shift, ws=7):
    """numpy model of csrc/window_attention.cu: per (window, head), each token's
    source offset from the shifted position, its region label from the
    cut at Hp - 7 and Hp - shift, the bias index from the window position."""
    qkv = qkv.double().numpy()
    table = table.double().numpy()
    b, hp, wp, c3 = qkv.shape
    c, d = c3 // 3, c3 // 3 // heads
    out = np.zeros((b, hp, wp, c))

    def region(p, size):
        return 0 if p < size - ws else (1 if p < size - shift else 2)

    for bi in range(b):
        for wy in range(hp // ws):
            for wx in range(wp // ws):
                src, lab, pos = [], [], []
                for t in range(ws * ws):
                    y_s, x_s = wy * ws + t // ws, wx * ws + t % ws
                    src.append(((y_s + shift) % hp, (x_s + shift) % wp))
                    lab.append(region(y_s, hp) * 3 + region(x_s, wp) if shift else 0)
                    pos.append((t // ws, t % ws))
                for h in range(heads):
                    q = np.stack([qkv[bi, y, x, h * d:(h + 1) * d] for y, x in src]) / math.sqrt(d)
                    k = np.stack([qkv[bi, y, x, c + h * d:c + (h + 1) * d] for y, x in src])
                    v = np.stack([qkv[bi, y, x, 2 * c + h * d:2 * c + (h + 1) * d]
                                  for y, x in src])
                    s = q @ k.T
                    for i, (yi, xi) in enumerate(pos):
                        for j, (yj, xj) in enumerate(pos):
                            s[i, j] += table[(yi - yj + 6) * 13 + (xi - xj + 6), h]
                            s[i, j] += -100.0 if lab[i] != lab[j] else 0.0
                    p = np.exp(s - s.max(1, keepdims=True))
                    o = (p / p.sum(1, keepdims=True)) @ v
                    for i, (y, x) in enumerate(src):
                        out[bi, y, x, h * d:(h + 1) * d] = o[i]
    return torch.from_numpy(out)


@pytest.mark.parametrize("shift", [0, 3])
def test_kernel_index_model_matches_the_plain_path(shift):
    heads = 2
    qkv, table = _qkv(1, 14, 21, 8 * heads, seed=3), _table(heads, seed=4)
    got = wa.window_attention_reference(qkv, table, heads, 7, shift).double()
    torch.testing.assert_close(got, _kernel_model(qkv, table, heads, shift), rtol=0, atol=1e-5)


def _old_init(det: Detector, gen: torch.Generator):
    """Detector.init_weights before the Swin backbone: normal / sqrt(fan_in)
    kernels, ones, zeros, the focal prior."""
    with torch.no_grad():
        for name, p in det.named_parameters():
            if name.endswith("weight") and p.dim() > 1:
                p.copy_(torch.randn(p.shape, generator=gen) / math.sqrt(p[0].numel()))
            elif name.endswith("weight") or ".scale" in name:
                p.fill_(1.0)
            else:
                p.zero_()
        det.heads.cls_logits.bias.fill_(-4.595)


def test_bias_tables_drawn_and_resnet_init_unchanged():
    det = Detector(_port_cfg())
    det.init_weights(torch.Generator().manual_seed(5))
    tables = [p for n, p in det.named_parameters() if n.endswith(swin.BIAS_TABLE)]
    assert len(tables) == 12
    flat = torch.cat([t.flatten() for t in tables])
    assert flat.numel() == 169 * (3 * 2 + 6 * 2 + 12 * 6 + 24 * 2)
    flat = flat.detach()
    assert 0.019 < float(flat.std()) < 0.021 and abs(float(flat.mean())) < 0.001
    for name in [n for n in _BACKBONES if n.startswith("resnet")]:
        cfg = _port_cfg(backbone=name, fpn_levels=[3, 4, 5])
        a, b = Detector(cfg), Detector(cfg)
        a.init_weights(torch.Generator().manual_seed(11))
        _old_init(b, torch.Generator().manual_seed(11))
        for (n, pa), pb in zip(a.state_dict().items(), b.state_dict().values()):
            assert torch.equal(pa, pb), (name, n)


def test_remat_recomputes_blocks_to_the_same_gradients():
    """``remat`` (training) checkpoints each block: the same gradients as
    keeping the activations, through the plain window path that a gradient
    takes."""
    grads = []
    for remat in (False, True):
        net = swin.SwinT(remat=remat).train()
        g = torch.Generator().manual_seed(2)
        with torch.no_grad():
            for p in net.parameters():
                p.copy_(torch.randn(p.shape, generator=g) * 0.05)
        feats = net(_images((64, 96), n=1, seed=4) / 255.0)
        sum(f.square().mean() for f in feats.values()).backward()
        grads.append([p.grad.clone() for p in net.parameters()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


@pytest.mark.parametrize("table_grad", [True, False])
def test_kernel_wrapper_backward_is_the_plain_paths_gradient(monkeypatch, table_grad):
    """The autograd function that a CUDA tensor takes (forward: the kernel,
    backward: the plain path recomputed), with the plain path standing in
    for the kernel on the CPU: the plain path's own gradients, bit for bit,
    and the forward's one launch."""
    launched = []

    def kernel(qkv, table, heads, window, shift):
        launched.append(table.dtype)
        return wa.window_attention_reference(qkv, table, heads, window, shift)

    monkeypatch.setattr(wa, "window_attention_cuda", kernel)
    heads, c = 3, 96
    base, table0 = _qkv(2, 14, 21, c, seed=6), _table(heads, seed=7)
    w = _qkv(2, 14, 21, c // 3, seed=8)[..., :c]
    grads = []
    for fn in (wa._KernelWithPlainBackward.apply, wa.window_attention_reference):
        qkv = base.clone().requires_grad_(True)
        table = table0.clone().requires_grad_(table_grad)
        out = fn(qkv, table, heads, 7, 3)
        (out * w).sum().backward()
        grads.append((out.detach(), qkv.grad, table.grad))
    assert launched == [torch.float32]
    assert (grads[0][2] is None) == (not table_grad)
    for got, want in zip(*grads):
        assert (got is None) == (want is None)
        if want is not None:
            assert torch.equal(got, want)


def test_int8_swin_is_refused():
    with pytest.raises(ValueError, match="int8"):
        Detector(_port_cfg(quant="int8"))


def test_backbone_span_and_window_counters(pair):
    _, prog = pair
    hw = DET["image_size"]
    profiling.reset_counters()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.no_grad():
            prog(_images(hw, n=3))
    got = profiling.counters()
    profiling.reset_counters()
    assert got["window_attn_launches"] == 12
    h, w, tokens = hw[0] // 4, hw[1] // 4, 0
    for depth in (2, 2, 6, 2):
        tokens += depth * (-(-h // 7) * 7) * (-(-w // 7) * 7)
        h, w = (h + 1) // 2, (w + 1) // 2
    assert got["window_attn_tokens"] == 3 * tokens
    names = [e.name for e in prof.events()]
    assert names.count("w2t/backbone") == 1


# ------------------------------------------------------------------ card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return torch.device("cuda")


# (B, Hp, Wp, C, heads) of the four stages of Swin-T at 640x960, B = 4
STAGES = [(4, 161, 245, 96, 3), (4, 84, 126, 192, 6), (4, 42, 63, 384, 12), (4, 21, 35, 768, 24)]


@pytest.mark.card
@pytest.mark.parametrize("shift", [0, 3])
@pytest.mark.parametrize("stage", range(4))
def test_card_kernel_matches_the_plain_path(card, stage, shift):
    """bf16: the kernel reads the bf16 inputs exactly and works in float32, so
    it stands from the plain path in float32 on the same inputs by its one
    rounding to bf16 (at most half a bf16 step, 2^-9 relative) plus float32
    summation order and __expf (some 1e-6 of the largest |v|): rtol 2^-8,
    atol 1e-5 x max|v|. float32: summation order and __expf alone, rtol 2e-5,
    atol 2e-6 x max|v|."""
    b, hp, wp, c, heads = STAGES[stage]
    table = _table(heads, seed=stage, device=card)
    for dtype, rtol, atol in ((torch.bfloat16, 2 ** -8, 1e-5), (torch.float32, 2e-5, 2e-6)):
        qkv = _qkv(b, hp, wp, c, seed=10 + stage, dtype=dtype, device=card)
        before = wa.window_attention_cuda.launches
        got = wa.window_attention_cuda(qkv, table, heads, 7, shift)
        torch.cuda.synchronize()
        assert wa.window_attention_cuda.launches == before + 1 and got.dtype == dtype
        want = wa.window_attention_reference(qkv.float(), table, heads, 7, shift)
        scale = float(qkv[..., 2 * c:].float().abs().max())
        torch.testing.assert_close(got.float(), want, rtol=rtol, atol=atol * scale)


@pytest.mark.card
def test_card_backward_launches_the_kernel(card):
    """A gradient on the card goes through the kernel too: its forward is
    the kernel's output and launches it once, and its gradients are the
    plain path's (float32, summation order alone apart); a training step of
    the backbone launches it once a block."""
    b, hp, wp, c, heads = STAGES[2]
    qkv0 = _qkv(2, hp, wp, c, seed=21, device=card)
    table0, w = _table(heads, seed=22, device=card), _qkv(2, hp, wp, c // 3, seed=23,
                                                         device=card)[..., :c]
    grads = []
    for fn in (wa.window_attention, wa.window_attention_reference):
        qkv, table = qkv0.clone().requires_grad_(True), table0.clone().requires_grad_(True)
        before = wa.window_attention_cuda.launches
        out = fn(qkv, table, heads, 7, 3)
        (out * w).sum().backward()
        torch.cuda.synchronize()
        grads.append((out.detach(), qkv.grad, table.grad, wa.window_attention_cuda.launches
                      - before))
    assert grads[0][3] == 1 and grads[1][3] == 0
    assert torch.equal(grads[0][0], wa.window_attention_cuda(qkv0, table0, heads, 7, 3))
    for got, want in zip(grads[0][:3], grads[1][:3]):
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5 * float(want.abs().max()))
    net = swin.SwinT().to(card).train()
    before = wa.window_attention_cuda.launches
    feats = net(_images((64, 96), n=2, seed=4).to(card) / 255.0)
    sum(f.square().mean() for f in feats.values()).backward()
    torch.cuda.synchronize()
    assert wa.window_attention_cuda.launches == before + 12
    tables = [p for n, p in net.named_parameters() if n.endswith(swin.BIAS_TABLE)]
    assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in tables)


@pytest.mark.card
def test_card_detector_float32_matches_the_reference(card):
    """The port's float32 detector on the card (the kernel in every block)
    against the reference's float32 forward, TF32 off on both: summation
    order only."""
    det = dict(DET, image_size=[128, 192])
    ref = ref_model.Detector(det).to(card).eval()
    ref_model.init_weights(ref, torch.Generator(device=card).manual_seed(19))
    prog = Detector(_port_cfg(image_size=[128, 192])).to(card).eval()
    prog.load_state_dict(ref.state_dict())
    x = _images(det["image_size"], n=3, seed=2).to(card)
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        before = wa.window_attention_cuda.launches
        with torch.no_grad():
            (h_ref, _), (h_got, _) = ref(x), prog(x)
        torch.cuda.synchronize()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    assert wa.window_attention_cuda.launches == before + 12
    for lvl in det["fpn_levels"]:
        for a, b in zip(h_got[lvl], h_ref[lvl]):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
