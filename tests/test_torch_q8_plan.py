"""Host-side parts of the W8A8 kernels 6, 7 and 8 on the card, on the CPU:
the s8 wgmma GEMM's plan (`ops/quant_matmul.q8_plan`: ring depth and
cluster) at the F5 bench shapes and over every weight shape `q8_fits`
admits, the K-major weight layout that `runtime/f5.quantize_dit` gives the
card route and that `models/f5._dit_block` hands the wrappers, and
`ops/_build.launch` making the tensors' device current around a launch,
with every per-device kernel attribute set through `raise_attr` in the
CUDA sources."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from tts_tpu_torch.models import f5 as tf5
from tts_tpu_torch.ops import _build
from tts_tpu_torch.ops.quant_matmul import Q8Plan, kmajor, q8_fits, q8_plan, to_kmajor
from tts_tpu_torch.quant.weight_only import QTensor, QTensorG
from tts_tpu_torch.runtime import f5 as rf5
from tts_tpu_torch.runtime.f5 import quantize_dit

H100_SMS = 132
CSRC = Path(__file__).resolve().parent.parent / "tts_tpu_torch" / "csrc"


def _tiles(rows, n):
    """(row tiles, column tiles, CTAs) of a GEMM in 128 x 128 CTAs."""
    rt, ct = -(-rows // 128), n // 128
    return rt, ct, rt * ct


@pytest.mark.parametrize("rows,n,k,whole,want", [
    # kernel 7: (2816 x 1024) . (1024 x 3072): 528 CTAs, two full waves of 2 an SM
    (2816, 3072, 1024, False, Q8Plan(3, 1)),
    # kernel 9 at its bench shape, x (2816, 1024) @ (1024, 3072): kernel 7's GEMM
    pytest.param(2816, 3072, 1024, False, Q8Plan(3, 1), id="kernel9-bench"),
    # kernel 6's ff1: clusters of 16 x 128 columns span F 2048
    (2816, 2048, 1024, True, Q8Plan(3, 16)),
    # kernel 6's ff2: (2816 x 2048) . (2048 x 1024), 176 CTAs
    (2816, 1024, 2048, False, Q8Plan(3, 1)),
    # ragged M (B 2, T 1400) and a half-empty last row tile (B 1, T 1088),
    # whose ff2 grid (72 CTAs) fits one CTA an SM
    (2800, 2048, 1024, True, Q8Plan(3, 16)),
    (1088, 1024, 2048, False, Q8Plan(4, 1)),
    # the bucket-1024 request's ff2 (B 2, T 1024): 128 CTAs, one wave
    (2048, 1024, 2048, False, Q8Plan(4, 1)),
    # D 640, F 1152: a cluster of 9 (non-portable); kernel 7 at D 576: a
    # last K step of 64
    (2816, 1152, 640, True, Q8Plan(3, 9)),
    (2816, 1152, 576, False, Q8Plan(3, 1)),
    # kernel 8, (M x 1024) . (1024 x 1024): the bench shape's 176 CTAs, the
    # bucket-1024 request's 128 and B 1 T 1088's 72
    (2816, 1024, 1024, False, Q8Plan(3, 1)),
    (2048, 1024, 1024, False, Q8Plan(4, 1)),
    (1088, 1024, 1024, False, Q8Plan(4, 1)),
])
def test_q8_plan_at_the_smoke_shapes(rows, n, k, whole, want):
    assert q8_plan(rows, n, k, H100_SMS, whole_rows=whole) == want


@pytest.mark.parametrize("sms", [H100_SMS, 114, 16])
@pytest.mark.parametrize("rows", [1, 64, 127, 1088, 2800, 2816, 9216])
def test_q8_plan_covers_every_admitted_shape(sms, rows):
    """Every (K, N) q8_fits admits (K % 64 up to 2048, N % 128), at any row
    count: a bias or residual GEMM takes 4 stages (one CTA an SM) exactly
    where its grid of 128 x 128 CTAs fits the card, else 3 stages (two an
    SM), and no cluster; a whole-row GEMM one cluster of N / 128 <= 16 CTAs
    that covers N exactly, 3 stages."""
    for k in range(64, 2049, 64):
        for n in range(128, 6145, 128):
            assert q8_fits(k, n)
            p = q8_plan(rows, n, k, sms)
            assert p.cluster == 1 and p.stages == (4 if _tiles(rows, n)[2] <= sms else 3)
            if n > 2048:
                continue
            w = q8_plan(rows, n, k, sms, whole_rows=True)
            assert w.cluster * 128 == n and 1 <= w.cluster <= 16 and w.stages == 3


@pytest.mark.parametrize("rows,n,k,whole", [
    (2816, 3072, 2112, False),      # depth past 2048
    (2816, 3072, 96, False),        # depth not a multiple of 64
    (2816, 1088, 1024, False),      # width not a multiple of 128
    (2816, 2176, 1024, True),       # a cluster of 17
    (0, 1024, 1024, False),
    (1 << 21, 1024, 2048, False),   # 2^32 values of A: past the copies' 32-bit offsets
    (1 << 22, 2048, 1024, True),
    (2816, 1 << 21, 2048, False),   # 2^32 values of B
])
def test_q8_plan_refuses_what_the_kernels_do_not_take(rows, n, k, whole):
    with pytest.raises(ValueError):
        q8_plan(rows, n, k, H100_SMS, whole_rows=whole)


def test_q8_plan_takes_operands_just_under_2_32_values():
    assert q8_plan((1 << 21) - 1, 1024, 2048, H100_SMS) == Q8Plan(3, 1)
    assert q8_plan(2816, (1 << 21) - 128, 2048, H100_SMS) == Q8Plan(3, 1)


def test_kmajor_is_the_transpose():
    """to_kmajor keeps the (K, N) weight and its values and stores it
    K-major; kmajor gives the (N, K) storage under it, without a copy, and
    refuses a row-major weight rather than transpose it."""
    w = torch.from_numpy(np.random.default_rng(0).integers(-127, 128, (192, 384),
                                                           dtype=np.int8))
    km = to_kmajor(w)
    assert km.shape == w.shape and torch.equal(km, w) and km.t().is_contiguous()
    t = kmajor(km)
    assert t.shape == (384, 192) and t.is_contiguous() and torch.equal(t, w.t())
    assert t.data_ptr() == km.data_ptr()
    with pytest.raises(ValueError, match="K-major"):
        kmajor(w)


SMALL = dict(dim=128, depth=2, heads=2, head_dim=64, ff_mult=2, text_dim=32,
             conv_layers=1, conv_mult=2, n_mels=16, vocab_size=20, nfe_steps=8,
             n_fft=256, hop=64, win_length=256, max_signal_len=128, freq_embed_dim=16)


@pytest.fixture(scope="module")
def params():
    cfg = tf5.F5Config(**SMALL)
    return cfg, tf5.init_params(cfg, torch.Generator().manual_seed(0), torch.float32)


def _card_params(tp, quantize):
    """quantize_dit's tree as it is made for params on a card."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(rf5, "_on_card", lambda p: True)
        return quantize_dit(tp, quantize)


def _kmajor(w) -> bool:
    return not w.q.is_contiguous() and w.q.t().is_contiguous()


@pytest.mark.parametrize("quantize", [8, "w8a8"])
def test_quantize_dit_makes_kmajor_copies_for_the_card_only(params, quantize):
    """The params lie on the CPU: every int8 q row-major. For params on a
    card, the q of wqkv, wo, ff1 and ff2 (the weights of kernels 7, 8 and
    6, whose s8 wgmma GEMM reads B K-major) is stored K-major with the same
    shape and values."""
    _, tp = params
    assert not rf5._on_card(tp)
    cpu, card = quantize_dit(tp, quantize), _card_params(tp, quantize)
    for blk, kblk in zip(cpu["blocks"], card["blocks"]):
        for w in (blk["attn"]["wqkv"], blk["attn"]["wo"], blk["ff1"]["w"], blk["ff2"]["w"]):
            assert w.q.is_contiguous()
        for key in (("attn", "wqkv"), ("attn", "wo"), ("ff1", "w"), ("ff2", "w")):
            w, kw = blk[key[0]][key[1]], kblk[key[0]][key[1]]
            assert isinstance(kw, QTensor) and kw.q.dtype == torch.int8
            assert torch.equal(kw.q, w.q) and torch.equal(kw.scale, w.scale)
            assert _kmajor(kw)


def test_quantize_dit_int4_has_no_kmajor_copy(params):
    _, tp = params
    blk = _card_params(tp, 4)["blocks"][0]
    assert isinstance(blk["ff1"]["w"], QTensorG) and blk["ff1"]["w"].q.is_contiguous()


def test_dit_block_hands_the_kmajor_copies_to_kernels_7_and_6(params, monkeypatch):
    """_dit_block hands ln_qkv_q8, out_proj_residual_q8 and
    mlp_block_fused_q8 the QTensors' q as they lie, K-major in the card's
    tree; the wrappers' CPU twins take either layout, so the block's output
    is the same bits in both trees."""
    cfg, tp = params
    seen = {}
    for name, pos in (("ln_qkv_q8", (2,)), ("out_proj_residual_q8", (1,)),
                      ("mlp_block_fused_q8", (2, 5))):
        fn = getattr(tf5, name)
        monkeypatch.setattr(tf5, name, lambda *a, _f=fn, _n=name, _p=pos, **kw:
                            (seen.__setitem__(_n, [a[i] for i in _p]), _f(*a, **kw))[1])
    t = 128
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, t, cfg.dim)).astype(np.float32))
    mod = tp["ada_table"][0, 0].reshape(1, 1, -1)
    rope = (tp["rope_cos"][:t], tp["rope_sin"][:t])
    outs = []
    for km in (True, False):
        tree = _card_params(tp, "w8a8") if km else quantize_dit(tp, "w8a8")
        blk = tree["blocks"][0]
        seen.clear()
        outs.append(tf5._dit_block(blk, x, mod, *rope, cfg, t - 8))
        assert set(seen) == {"ln_qkv_q8", "out_proj_residual_q8", "mlp_block_fused_q8"}
        assert seen["ln_qkv_q8"][0] is blk["attn"]["wqkv"].q
        assert seen["out_proj_residual_q8"][0] is blk["attn"]["wo"].q
        assert seen["mlp_block_fused_q8"] == [blk["ff1"]["w"].q, blk["ff2"]["w"].q]
        assert all(q.t().is_contiguous() == km for v in seen.values() for q in v)
    assert torch.equal(outs[0], outs[1])


def test_launch_runs_under_the_tensors_device(monkeypatch):
    """_build.launch makes the given device current around the C call where
    another is current (the C entries cache per-device state by
    cudaGetDevice and launch on the current device) and leaves it alone
    where it is, raises on an error code, and counts the launch."""
    events = []

    class Device:
        def __init__(self, d):
            self.d = d

        def __enter__(self):
            events.append(("enter", self.d))

        def __exit__(self, *exc):
            events.append(("exit", self.d))

    class Lib:
        @staticmethod
        def tts_cuda_error_string(err):
            return b"bad"

    def entry(*args):
        events.append(("call", args))
        return args[0]

    Lib.fake_entry = staticmethod(entry)
    monkeypatch.setattr(_build, "library", lambda: Lib)
    monkeypatch.setattr(_build.torch.cuda, "device", Device)
    monkeypatch.setattr(_build.torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(_build, "_declared", {"fake_entry"})
    dev = torch.device("cuda", 3)
    before = _build.LAUNCHES["fake_entry"]
    _build.launch("fake_entry", [], 0, 7, device=dev)
    assert events == [("enter", dev), ("call", (0, 7)), ("exit", dev)]
    events.clear()
    _build.launch("fake_entry", [], 0, 8, device=torch.device("cuda", 0))
    assert events == [("call", (0, 8))]
    assert _build.LAUNCHES["fake_entry"] == before + 2
    with pytest.raises(RuntimeError, match="bad"):
        _build.launch("fake_entry", [], 5, device=dev)
    assert _build.LAUNCHES["fake_entry"] == before + 2
    _build.LAUNCHES.pop("fake_entry")


def test_kernel_attributes_are_cached_per_device():
    """No C entry keeps a kernel attribute or an SM count in a process-wide
    scalar: cudaFuncSetAttribute runs only inside common.cuh's raise_attr
    (one slot a device), and no source holds a `static bool` or a scalar
    `static int` / `static size_t` cache."""
    calls, scalars = [], []
    for path in sorted(CSRC.glob("*.cu*")):
        text = path.read_text()
        calls += [path.name for _ in re.finditer(r"cudaFuncSetAttribute\(", text)]
        scalars += [f"{path.name}: {m.group(0)}" for m in re.finditer(
            r"static\s+(bool|size_t|int)\s+\w+\s*(=|;)", text)]
    assert calls == ["common.cuh"]
    assert scalars == []
