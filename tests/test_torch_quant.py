"""The port's int8 post-training quantization (``models/quant.py``, the
calibration hooks of ``DetectorRunner`` and of every driver) against the JAX
package's ``models/quant.py`` on the CPU.

- ``QuantConv2d`` in int8 is bit-equal to the JAX ``QuantConv`` applied op by
  op, given the same input and absmax, in float32 and bfloat16, for every
  conv shape the trunk has. (Under ``jit`` XLA folds ``/ 127.0`` into a
  reciprocal multiply, reassociates the scale products by shape and fuses
  the bias add into an FMA: an ulp or two, which the detector-level test's
  tolerance covers.)
- ``calib`` is bit-identical to the float conv, records JAX's absmax, and a
  tower shared across levels records one maximum over them.
- A whole ``SLIM_INT8`` detector with the JAX package's calibrated variables
  carried over gives JAX's detections within the tolerance stated at the
  test; the int8 codes that flip there are counted.
- Serving uncalibrated int8 raises in ``detect`` and in every driver; every
  driver calibrates itself on its first real frames.
- The trained fixture's int8 pixel goldens meet the JAX test's floors.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import linen as nn

from waymo_2d_tracking_tpu.config import DetectorConfig as JaxDetectorConfig
from waymo_2d_tracking_tpu.models import quant as jq
from waymo_2d_tracking_tpu.models.detector import DetectorRunner as JaxRunner
from waymo_2d_tracking_tpu.models.heads import FCOSHeads as JaxFCOSHeads

from waymo_2d_tracking_tpu_torch.config import (
    Config,
    DetectorConfig,
    PipelineConfig,
    TrackerConfig,
)
from waymo_2d_tracking_tpu_torch.data.synthetic import SyntheticClipConfig, render_video_clip
from waymo_2d_tracking_tpu_torch.eval.mot import evaluate_mot, gt_to_frames
from waymo_2d_tracking_tpu_torch.models import quant
from waymo_2d_tracking_tpu_torch.models.detector import DetectorRunner
from waymo_2d_tracking_tpu_torch.models.heads import FCOSHeads
from waymo_2d_tracking_tpu_torch.pipeline import multicam, online, run
from waymo_2d_tracking_tpu_torch.weights import fixture_state_dict, from_flax_numpy

from test_torch_pipeline import CLIP_KW, DET_KW, TRK_KW, records_to_frames

# xdist runs several workers on the machine's cores; one torch thread each
torch.set_num_threads(1)

# tests/unit/test_quant.py SLIM_INT8
SLIM_DET = dict(
    backbone="resnet18slim", image_size=(64, 96), fpn_channels=32, head_depth=1,
    pre_nms_topk=32, max_detections=8, embed_dim=16, reid_channels=32,
    dtype="float32", score_threshold=0.01, quant="int8",
)
SLIM_TRK = dict(max_tracks=16, max_detections=8, embed_dim=16, score_threshold=0.0,
                birth_score_threshold=0.0, n_init=1)


def slim_cfg(**det):
    return Config(detector=DetectorConfig(**{**SLIM_DET, **det}),
                  tracker=TrackerConfig(**SLIM_TRK), pipeline=PipelineConfig(chunk_frames=2))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ----------------------------------------------------------- one conv layer

# (cin, cout, kernel, stride, padding) where padding is a symmetric int, a
# flax pad list, or "SAME"; "s2d" is the stem: 12 channels, 4x4, pad
# [(2, 1), (2, 1)] applied outside the conv (K = 192); "conv7" K = 147
CONVS = {
    "3x3_s1": (8, 16, 3, 1, 1),
    "3x3_s2": (8, 16, 3, 2, 1),
    "1x1_s1": (16, 24, 1, 1, 0),
    "1x1_s2": (16, 24, 1, 2, 0),
    "s2d_stem": (12, 16, 4, 1, [(2, 1), (2, 1)]),
    "conv7_stem": (3, 16, 7, 2, 3),
    "3x3_same": (8, 16, 3, 1, "SAME"),
}


def _conv_inputs(cin, cout, k, seed, hw=(14, 18)):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2,) + hw + (cin,)).astype(np.float32)
    kern = (rng.normal(size=(k, k, cin, cout)) / np.sqrt(k * k * cin)).astype(np.float32)
    bias = (0.1 * rng.normal(size=(cout,))).astype(np.float32)
    return x, kern, bias


def _port_conv(cin, cout, k, stride, pad, mode, dtype, kern, bias, absmax=0.0):
    sym = pad if isinstance(pad, int) else (k // 2 if pad == "SAME" else 0)
    conv = quant.make_conv(mode, cin, cout, k, stride, padding=sym, dtype=dtype)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(kern.transpose(3, 2, 0, 1)))
        conv.bias.copy_(torch.from_numpy(bias))
        if mode != "off":
            conv.act_absmax.fill_(absmax)
    return conv


def _port_apply(conv, x_nhwc, pad):
    x = torch.from_numpy(np.array(x_nhwc)).permute(0, 3, 1, 2)
    if isinstance(pad, list):               # the s2d stem's asymmetric pad, as in ResNet
        (t, b), (lft, r) = pad
        x = F.pad(x, (lft, r, t, b))
    with torch.no_grad():
        return conv(x).permute(0, 2, 3, 1).float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(CONVS))
def test_int8_conv_bit_equal_to_jax(name, dtype):
    cin, cout, k, stride, pad = CONVS[name]
    x, kern, bias = _conv_inputs(cin, cout, k, seed=len(name))
    absmax = np.float32(0.8 * np.abs(x).max())       # some inputs saturate at +-127
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32,
                                                                           torch.float32)
    xj = jnp.asarray(x).astype(jdt)                  # the previous layer's output dtype
    jpad = pad if isinstance(pad, (str, list)) else [(pad, pad), (pad, pad)]
    module = jq.QuantConv(features=cout, kernel_size=(k, k), strides=(stride, stride),
                          padding=jpad, dtype=jdt, mode="int8")
    variables = {"params": {"kernel": kern, "bias": bias}, "quant": {"act_absmax": absmax}}
    with jax.disable_jit():
        want = np.asarray(module.apply(variables, xj).astype(jnp.float32))
    conv = _port_conv(cin, cout, k, stride, pad, "int8", tdt, kern, bias, float(absmax))
    got = _port_apply(conv, np.asarray(xj.astype(jnp.float32)), pad)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["3x3_s2", "s2d_stem", "conv7_stem"])
def test_calib_is_the_float_conv_and_records_jax_absmax(name):
    cin, cout, k, stride, pad = CONVS[name]
    x, kern, bias = _conv_inputs(cin, cout, k, seed=3)
    plain = _port_conv(cin, cout, k, stride, pad, "off", torch.float32, kern, bias)
    calib = _port_conv(cin, cout, k, stride, pad, "calib", torch.float32, kern, bias)
    assert type(plain) is torch.nn.Conv2d
    np.testing.assert_array_equal(_port_apply(calib, x, pad), _port_apply(plain, x, pad))
    jpad = pad if isinstance(pad, (str, list)) else [(pad, pad), (pad, pad)]
    module = jq.QuantConv(features=cout, kernel_size=(k, k), strides=(stride, stride),
                          padding=jpad, dtype=jnp.float32, mode="calib")
    _, upd = module.apply({"params": {"kernel": kern, "bias": bias}}, jnp.asarray(x),
                          mutable=["quant"])
    assert float(calib.act_absmax) == float(upd["quant"]["act_absmax"]) == np.abs(x).max()


def test_calibration_running_max_and_shared_tower_levels():
    conv = quant.make_conv("calib", 4, 8, 3, padding=1)
    for v in (2.0, 5.0, 3.0):
        conv(torch.full((1, 4, 8, 8), v))
    assert float(conv.act_absmax) == 5.0
    # one absmax per tower conv over every pyramid level, as the JAX heads
    rng = np.random.default_rng(4)
    feats = {lvl: rng.normal(size=(1, 16 >> (lvl - 3), 24 >> (lvl - 3), 32)).astype(np.float32)
             * (lvl - 2) for lvl in (3, 4, 5)}
    jheads = JaxFCOSHeads(num_classes=3, depth=2, channels=32, levels=(3, 4, 5),
                          dtype=jnp.float32, quant="calib")
    jfeats = {lvl: jnp.asarray(f) for lvl, f in feats.items()}
    variables = jheads.init(jax.random.PRNGKey(0), jfeats)
    _, upd = jheads.apply({"params": variables["params"]}, jfeats, mutable=["quant"])
    heads = FCOSHeads(32, num_classes=3, depth=2, channels=32, levels=(3, 4, 5), quant="calib")
    heads.load_state_dict(from_flax_numpy({"params": _np_tree(variables["params"])}),
                          strict=False)
    with torch.no_grad():
        heads({lvl: torch.from_numpy(f).permute(0, 3, 1, 2) for lvl, f in feats.items()})
    want = _np_tree(upd["quant"])
    assert float(heads.cls_tower.conv0.act_absmax) == max(np.abs(f).max() for f in feats.values())
    for tower in ("cls_tower", "box_tower"):
        for i in range(2):
            np.testing.assert_allclose(
                float(getattr(getattr(heads, tower), f"conv{i}").act_absmax),
                float(want[tower][f"conv{i}"]["act_absmax"]), rtol=1e-5)


def test_quantize_symmetric_rounds_half_even_and_saturates():
    x = np.array([-300.0, -2.5, -1.0, 0.0, 0.5, 1.5, 2.5, 126.6, 300.0], np.float32)
    got = quant.quantize_symmetric(torch.from_numpy(x), torch.tensor(1.0)).numpy()
    want = np.asarray(jq.quantize_symmetric(jnp.asarray(x), jnp.asarray(1.0)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [-127, -2, -1, 0, 0, 2, 2, 127, 127])
    assert got.dtype == np.int8


def test_is_calibrated_states():
    assert not quant.is_calibrated(torch.nn.Conv2d(3, 4, 3))         # nothing quantized
    seq = torch.nn.Sequential(quant.make_conv("int8", 3, 4, 3), quant.make_conv("int8", 4, 4, 1))
    assert not quant.is_calibrated(seq)                              # zero absmax
    seq[0].act_absmax.fill_(1.0)
    assert not quant.is_calibrated(seq)                              # one still zero
    seq[1].act_absmax.fill_(0.5)
    assert quant.is_calibrated(seq)
    with quant.quant_mode(seq, "calib"):
        assert {m.mode for m in seq} == {"calib"}
    assert {m.mode for m in seq} == {"int8"}


@pytest.mark.parametrize("mkn", [(6, 147, 16), (16, 192, 64), (17, 152, 20), (2, 36, 3),
                                 (100, 4608, 512)])
def test_int8_gemm_padding_model_exact(mkn):
    """The zero padding ``int8_gemm`` applies for the card's ``_int_mm``
    (M > 16, K and N multiples of 8), modelled in numpy int64, changes no
    sum; the port's ``int8_gemm`` on CPU tensors equals it."""
    m, k, n = mkn
    rng = np.random.default_rng(m + k + n)
    a = rng.integers(-127, 128, (m, k), dtype=np.int8)
    w = rng.integers(-127, 128, (n, k), dtype=np.int8)
    mp, kp, np_ = quant.gemm_pads(m, k, n)
    assert mp > 16 and kp % 8 == 0 and np_ % 8 == 0 and (mp, kp, np_) >= (m, k, n)
    ap = np.zeros((mp, kp), np.int64)
    ap[:m, :k] = a
    wp = np.zeros((np_, kp), np.int64)
    wp[:n, :k] = w
    want = a.astype(np.int64) @ w.astype(np.int64).T
    np.testing.assert_array_equal((ap @ wp.T)[:m, :n], want)
    before = quant.int8_gemm.launches
    got = quant.int8_gemm(torch.from_numpy(a), torch.from_numpy(w))
    assert got.dtype == torch.int32 and quant.int8_gemm.launches == before + 1
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------------ the detector

def _slim_images(n=2, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (n, 64, 96, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def slim_params():
    """The JAX SLIM_INT8 detector's initial variables (jitted init: the eager
    one takes half a minute); the scope and thresholds do not change them."""
    runner = JaxRunner(JaxDetectorConfig(**SLIM_DET), interpret=True)
    return jax.jit(lambda key: runner.init_params(key, batch_size=2))(jax.random.PRNGKey(0))


def _intercepted_inputs():
    """flax interceptor sending each QuantConv's input (module path -> x) to
    the host from inside ``jit``."""
    seen = {}

    def interceptor(next_fun, args, kwargs, context):
        if isinstance(context.module, jq.QuantConv) and context.method_name == "__call__":
            name = "/".join(context.module.path)
            jax.debug.callback(
                lambda v, name=name: seen.setdefault(name, []).append(np.array(v, np.float32)),
                args[0])
        return next_fun(*args, **kwargs)
    return seen, interceptor


def test_slim_int8_detections_match_jax_with_carried_calibration(slim_params):
    """JAX calibrates and detects (``quant_scope='all'``: every conv but the
    predictors quantized); its variables (params, batch_stats and the
    'quant' absmax) go to the port, which detects on the same images.

    Each quantized conv's input comes from float layers that sum in another
    order in PyTorch than in XLA, and XLA's ``jit`` rounds the scales an ulp
    or two apart (``models/quant.py``), so an input within that of a rounding
    boundary takes the neighbouring int8 code: the codes that flip are
    counted (1284 of 379904, 0.34 %, when written; bound 1 %; the image, the
    stem's input, never flips), and a flip moves its conv's output by one
    quantization step, which the next layers carry on. Tolerances: scores
    2e-3, boxes 1 px (random weights decode ltrb through exp), embeddings
    0.05; valid and classes exact. For scale: the int8 detector moves the
    same detections from the float detector's by 3.3e-3 in score and 82 px
    in box."""
    jcfg = JaxDetectorConfig(**SLIM_DET, quant_scope="all")
    jrunner = JaxRunner(jcfg, interpret=True)
    images = _slim_images()
    params = jrunner.calibrate(slim_params, jnp.asarray(images))
    # the inputs of every quantized conv, sent out of the jitted detect
    jseen, interceptor = _intercepted_inputs()
    with nn.intercept_methods(interceptor):
        want = jax.block_until_ready(jrunner.detect(params, jnp.asarray(images)))
    runner = DetectorRunner(DetectorConfig(**SLIM_DET, quant_scope="all"),
                            from_flax_numpy(_np_tree(params)), device="cpu")
    assert quant.is_calibrated(runner.module)
    for name, m in quant.named_quant_convs(runner.module):
        leaf = params["quant"]
        for p in name.split("."):
            leaf = leaf[p]
        assert float(m.act_absmax) == float(leaf["act_absmax"]), name

    # the same inputs in the port -> int8 codes in both packages; a tower
    # shared across levels sees one input a level
    tseen = {}
    hooks = [m.register_forward_pre_hook(
        lambda mod, args, name=name: tseen.setdefault(name, []).append(args[0].detach()))
        for name, m in quant.named_quant_convs(runner.module)]
    got = runner.detect(torch.from_numpy(images)).to_numpy()
    for h in hooks:
        h.remove()
    flips = total = 0
    for name, xs in tseen.items():
        if name.startswith("reid"):
            continue               # pooled per detection: compared through the embeddings
        if name == "backbone.stem_conv" and runner.cfg.stem == "s2d":
            xs = [x[..., 2:-1, 2:-1] for x in xs]    # the port pads the s2d stem outside
        scale = runner.module.get_submodule(name).act_absmax / quant.QMAX
        by_size = lambda a: -a.size    # noqa: E731  (callbacks need not keep program order)
        tqs = sorted((quant.quantize_symmetric(x.permute(0, 2, 3, 1).float(), scale).numpy()
                      for x in xs), key=by_size)
        jqs = sorted((quant.quantize_symmetric(torch.from_numpy(x), scale).numpy()
                      for x in jseen[name.replace(".", "/")]), key=by_size)
        assert [t.shape for t in tqs] == [j.shape for j in jqs], name
        for tq, jqc in zip(tqs, jqs):
            flips += int((tq != jqc).sum())
            total += tq.size
            if name == "backbone.stem_conv":
                assert (tq == jqc).all()
    print(f"int8 codes that flip between the packages: {flips} of {total}")
    assert flips <= 1e-2 * total, (flips, total)

    np.testing.assert_array_equal(got.valid, np.asarray(want.valid))
    np.testing.assert_array_equal(got.classes, np.asarray(want.classes))
    np.testing.assert_allclose(got.scores, np.asarray(want.scores), atol=2e-3)
    np.testing.assert_allclose(got.boxes, np.asarray(want.boxes), atol=1.0)
    np.testing.assert_allclose(got.embeds, np.asarray(want.embeds), atol=0.05)


def test_reid_calibration_survives_zero_valid_detections(slim_params):
    """An online session calibrates on one frame; with no detection above the
    score threshold, masking every slot would leave the ReID tower's absmax 0
    (uncalibrated); the unmasked pooled features are used instead
    (tests/unit/test_quant.py), here with the ReID tower quantized
    (quant_scope='all') so its calibration runs. The absmax equals JAX's."""
    det = dict(SLIM_DET, score_threshold=0.999999, quant_scope="all")
    jrunner = JaxRunner(JaxDetectorConfig(**det), interpret=True)
    images = _slim_images(1, seed=1)
    calibrated = jrunner.calibrate(slim_params, jnp.asarray(images))
    runner = DetectorRunner(DetectorConfig(**det), from_flax_numpy(_np_tree(slim_params)),
                            device="cpu")
    runner.calibrate(torch.from_numpy(images))
    assert quant.is_calibrated(runner.module)
    runner.detect(torch.from_numpy(images))          # the guard passes
    for i in range(2):
        np.testing.assert_allclose(
            float(getattr(runner.module.reid, f"conv{i}").act_absmax),
            float(calibrated["quant"]["reid"][f"conv{i}"]["act_absmax"]), rtol=1e-4)


def test_bf16_calibration_records_jax_absmax(slim_params):
    """Under bf16 (the shipped presets' dtype: the port under autocast, flax
    modules in bfloat16) each conv's recorded absmax is that of its input in
    bfloat16, as the JAX conv sees it: the stem's (the image cast to bf16)
    exactly, deeper convs' within two bf16 steps (their inputs come from
    float layers that round apart in the two packages)."""
    det = dict(SLIM_DET, dtype="bfloat16", quant_scope="all")
    jrunner = JaxRunner(JaxDetectorConfig(**det), interpret=True)
    images = _slim_images(seed=2)
    calibrated = jrunner.calibrate(slim_params, jnp.asarray(images))
    runner = DetectorRunner(DetectorConfig(**det), from_flax_numpy(_np_tree(slim_params)),
                            device="cpu")
    runner.calibrate(torch.from_numpy(images))
    for name, m in quant.named_quant_convs(runner.module):
        if name.startswith("reid"):
            continue                # pooled from detections that differ at bf16
        leaf = calibrated["quant"]
        for p in name.split("."):
            leaf = leaf[p]
        want = float(leaf["act_absmax"])
        if name == "backbone.stem_conv":
            assert float(m.act_absmax) == want
        np.testing.assert_allclose(float(m.act_absmax), want, rtol=2 ** -6, err_msg=name)


def test_uncalibrated_detect_raises_and_guard_remembers():
    runner = DetectorRunner(DetectorConfig(**SLIM_DET), device="cpu")
    images = torch.from_numpy(_slim_images())
    with pytest.raises(RuntimeError, match="calibrat"):
        runner.detect(images)
    from waymo_2d_tracking_tpu_torch.pipeline.tta import detect_tta_batch
    with pytest.raises(RuntimeError, match="calibrat"):
        detect_tta_batch(runner, images, scales=(1.0,), flip=True)
    runner.calibrate(images)
    runner.detect(images)
    assert runner._calib_ok_key == runner._absmax_key()
    runner.module.backbone.stem_conv.act_absmax.zero_()     # a write is seen
    with pytest.raises(RuntimeError, match="calibrat"):
        runner.detect(images)


def _frames(t, cams=None, seed=3):
    shape = (t,) + ((cams,) if cams else ()) + (64, 96, 3)
    return np.random.default_rng(seed).integers(0, 255, shape, dtype=np.uint8)


DRIVERS = ("run_segment", "run_segments", "multicam_run", "run_segments_group",
           "online", "online_rig")


def _drive(driver, cfg, tmp_path):
    """Run ``driver`` on small int8 inputs; returns its detector."""
    if driver in ("run_segment", "run_segments"):
        pipe = run.SegmentPipeline(cfg, device="cpu")
        seg = run.SegmentFrames("ctx", 1, list(range(3)), _frames(3))
        if driver == "run_segment":
            pipe.run_segment(seg)
        else:
            run.run_segments(pipe, [seg], str(tmp_path))
        return pipe.detector
    if driver in ("multicam_run", "run_segments_group"):
        pipe = multicam.MultiCamPipeline(cfg, num_cams=2, device="cpu")
        frames = _frames(3, cams=2)
        if driver == "multicam_run":
            pipe.run(frames)
        else:
            pipe.run_segments_group([run.SegmentFrames("ctx", c + 1, list(range(3)), frames[:, c])
                                     for c in range(2)], str(tmp_path))
        return pipe.detector
    if driver == "online":
        sess = online.OnlineTracker(cfg, device="cpu")
        sess.warmup((64, 96))                 # runs before calibration, outputs dropped
        assert not quant.is_calibrated(sess.detector.module)   # zero frames never calibrate
        for t, f in enumerate(_frames(2)):
            sess.step(f, t)
        return sess.detector
    rig = online.OnlineMultiCamTracker(cfg, camera_names=[1, 2], device="cpu")
    rig.warmup((64, 96))
    assert not quant.is_calibrated(rig.detector.module)
    for t, f in enumerate(_frames(2, cams=2)):
        rig.step(list(f), t)
    return rig.detector


@pytest.mark.parametrize("driver", DRIVERS)
def test_every_driver_calibrates_and_refuses_uncalibrated(driver, tmp_path, monkeypatch):
    """Each driver calibrates on its first real frames and then serves int8;
    with calibration made a no-op it raises at its first step instead of
    serving the 1.0-scale fallback."""
    detector = _drive(driver, slim_cfg(), tmp_path / "a")
    assert quant.is_calibrated(detector.module)
    assert all(m.mode == "int8" for m in quant.quant_convs(detector.module))
    monkeypatch.setattr(DetectorRunner, "calibrate", lambda self, images: None)
    with pytest.raises(RuntimeError, match="calibrat"):
        _drive(driver, slim_cfg(), tmp_path / "b")


# ----------------------------------------- the int8 pixel goldens (JAX floors)

@pytest.mark.parametrize("clip_name", ["seed5", "dense"])
def test_int8_pixel_goldens_meet_jax_floors(clip_name):
    """tests/golden/test_pixels_to_mota.py test_int8_quality_through_trained_fixture
    through the port: the trained fixture, quant='int8' at scope 'trunk',
    auto-calibrated on the first chunk, the JAX test's floors (the JAX CPU
    measured 0.6912 / 0.8504 / 8 and 0.4246 / 0.6746 / 6)."""
    clip = SyntheticClipConfig(**CLIP_KW) if clip_name == "seed5" else SyntheticClipConfig(
        num_frames=80, num_objects=14, image_size=(1024, 1536), seed=11)
    frames, gt = render_video_clip(clip)
    cfg = Config(detector=DetectorConfig(**DET_KW, quant="int8", quant_scope="trunk"),
                 tracker=TrackerConfig(**TRK_KW),
                 pipeline=PipelineConfig(chunk_frames=16, interp_max_gap=0))
    pipe = run.SegmentPipeline(cfg, fixture_state_dict("pixels_detector"), device="cpu")
    before = quant.int8_gemm.launches
    records, _ = pipe.run_segment(run.SegmentFrames(clip_name, 1, list(range(clip.num_frames)),
                                                    frames))
    assert quant.int8_gemm.launches > before
    m = evaluate_mot(gt_to_frames(gt), records_to_frames(records, clip.num_frames))
    d = m.as_dict()
    print(f"port int8 {clip_name}: {d}")
    if clip_name == "seed5":
        assert m.mota >= 0.66 and m.idf1 >= 0.82 and m.num_idsw <= 10, d
    else:
        assert m.mota >= 0.40 and m.idf1 >= 0.65 and m.num_idsw <= 8, d
