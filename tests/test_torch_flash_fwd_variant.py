"""Which of B1's kernels a call of the port's flash forward takes
(horovod_tpu_torch/ops/flash_attention.py ``_fwd_variant``), checked on
the CPU: the rule is a pure function of dtype, shape, strides and
pointers, so it needs no card.

- bf16 with D % 8 == 0, every [B, S, H] row start 16-byte aligned and
  positive B, S and H strides takes "tma" (TMA + wgmma), any other bf16
  (K/V expanded over B or H among them) "mma", float32 "fma";
- a named variant that cannot take the arguments raises before anything
  is built or launched;
- CPU tensors still go to the plain version, and no count moves.

The kernels themselves run only on the card (chip_smoke.py holds every
variant to the plain version there).
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from horovod_tpu_torch.ops import flash_attention as fa  # noqa: E402


def _counts():
    return (fa.flash_fwd_cuda.launches,
            dict(fa.flash_fwd_cuda.variant_launches))


def _qkv(dtype, D, layout, B=2, S=24, H=3):
    """q, k, v ``[B, S, H, D]`` from a seeded numpy draw, laid out as
    ``layout`` says: "contiguous"; "transposed" (a [B, H, S, D] buffer
    seen through transpose(1, 2)); "offset" (one element into a flat
    buffer, so no row start is 16-byte aligned)."""
    rng = np.random.default_rng(D)
    n = B * S * H * D
    out = []
    for _ in range(3):
        x = torch.tensor(rng.standard_normal(n + 1), dtype=torch.float32)
        x = x.to(dtype)
        if layout == "contiguous":
            t = x[:n].view(B, S, H, D)
        elif layout == "transposed":
            t = x[:n].view(B, H, S, D).transpose(1, 2)
        else:
            t = x[1:].view(B, S, H, D)
        out.append(t)
    return out


@pytest.mark.parametrize("layout", ["contiguous", "transposed", "offset"])
@pytest.mark.parametrize("D", [16, 32, 64, 100, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_variant_rule(dtype, D, layout):
    q, k, v = _qkv(dtype, D, layout)
    assert q.stride(-1) == 1
    aligned = layout != "offset"
    if dtype == torch.float32:
        want = "fma"
    elif D % 8 == 0 and aligned:
        want = "tma"
    else:
        want = "mma"
    assert fa._fwd_variant(q, k, v) == want
    takes = {var for var in fa._FWD_VARIANTS if fa._fwd_takes(var, q, k, v)}
    assert want in takes
    assert takes == ({"fma"} if dtype == torch.float32
                     else {"mma", "tma"} if want == "tma" else {"mma"})


def test_one_misaligned_tensor_leaves_tma():
    """The rule looks at q, k and v alike: one unaligned input is enough
    to send the call to the mma.sync kernel."""
    q, k, _ = _qkv(torch.bfloat16, 64, "contiguous")
    _, _, v = _qkv(torch.bfloat16, 64, "offset")
    assert fa._fwd_variant(q, k, v) == "mma"
    assert fa._fwd_variant(q, k, k) == "tma"


@pytest.mark.parametrize("over,strides", [
    ("B", (0, 192, 64, 1)), ("H", (1536, 64, 0, 1))])
def test_expanded_kv_leaves_tma(over, strides):
    """K/V expanded over B or H (a stride of 0, which no TMA map takes)
    send the call to the mma.sync kernel, as the backward's rule does,
    and a forced "tma" raises before any launch."""
    q, k, v = _qkv(torch.bfloat16, 64, "contiguous")
    if over == "B":
        k, v = (t[:1].expand(2, 24, 3, 64) for t in (k, v))
    else:
        k, v = (t[:, :, :1].contiguous().expand(2, 24, 3, 64)
                for t in (k, v))
    assert k.stride() == v.stride() == strides
    assert fa._fwd_variant(q, k, v) == "mma"
    assert {var for var in fa._FWD_VARIANTS
            if fa._fwd_takes(var, q, k, v)} == {"mma"}
    assert not fa._bwd_takes("tma", q, k, v, q)
    assert fa._fwd_variant(q, q, q) == "tma"
    before = _counts()
    with pytest.raises(ValueError, match="variant 'tma' does not take"):
        fa.flash_fwd_cuda(q, k, v, "diag", 64 ** -0.5, variant="tma")
    assert _counts() == before


@pytest.mark.parametrize("variant,dtype,D,layout", [
    ("tma", torch.float32, 64, "contiguous"),    # bf16 only
    ("tma", torch.bfloat16, 100, "contiguous"),  # D % 8 != 0
    ("tma", torch.bfloat16, 64, "offset"),       # rows not 16-byte aligned
    ("mma", torch.float32, 64, "contiguous"),
    ("fma", torch.bfloat16, 64, "contiguous"),
    ("wgmma", torch.bfloat16, 64, "contiguous"),  # no such variant
])
def test_forced_variant_that_cannot_take_raises_before_launch(
        variant, dtype, D, layout):
    q, k, v = _qkv(dtype, D, layout)
    before = _counts()
    with pytest.raises(ValueError, match=f"variant {variant!r} does not "
                                         f"take"):
        fa.flash_fwd_cuda(q, k, v, "diag", D ** -0.5, variant=variant)
    assert _counts() == before


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("mode", fa.MODES)
def test_cpu_tensors_take_the_plain_version(dtype, mode):
    q, k, v = _qkv(dtype, 64, "contiguous", S=40)
    before = _counts()
    o, lse = fa.flash_attention_lse(q, k, v, mode=mode, block=16)
    po, plse = fa._flash_plain(q, k, v, mode, 64 ** -0.5,
                               fa._validate(q, k, v, 16))
    assert torch.equal(o, po) and torch.equal(lse, plse)
    assert o.dtype == dtype and lse.dtype == torch.float32
    assert _counts() == before
