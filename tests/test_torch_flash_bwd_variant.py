"""Which of B2's and B3's kernels a call of the port's flash backward takes
(horovod_tpu_torch/ops/flash_attention.py ``_bwd_variant``), checked on
the CPU: the rule is a pure function of dtype, shape, strides and
pointers, so it needs no card.

- bf16 with D % 8 == 0 and q, k, v and dO each 16-byte aligned with
  positive strides takes "tma" (TMA + wgmma), any other bf16 "mma",
  float32 "fma";
- dO, which autograd may hand over non-contiguous or as an expanded zero,
  is passed through when a TMA map takes it as it lies, and copied
  contiguous when q, k and v would take "tma" and dO alone would not;
- a named variant that cannot take the arguments raises before anything
  is built or launched;
- CPU tensors still go to the plain backward, and no count moves.

The kernels themselves run only on the card (chip_smoke.py holds every
variant to the plain version there).
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from horovod_tpu_torch.ops import flash_attention as fa  # noqa: E402


def _counts():
    return tuple((w.launches, dict(w.variant_launches))
                 for w in (fa.flash_fwd_cuda, fa.flash_bwd_dq_cuda,
                           fa.flash_bwd_dkv_cuda))


def _tensors(dtype, D, layout, n=4, B=2, S=24, H=3, seed=None):
    """``n`` tensors ``[B, S, H, D]`` (q, k, v, dO) from a seeded numpy
    draw, laid out as ``layout`` says: "contiguous"; "transposed" (a
    [B, H, S, D] buffer seen through transpose(1, 2)); "offset" (one
    element into a flat buffer, so no row start is 16-byte aligned)."""
    rng = np.random.default_rng(D if seed is None else seed)
    size = B * S * H * D
    out = []
    for _ in range(n):
        x = torch.tensor(rng.standard_normal(size + 1), dtype=torch.float32)
        x = x.to(dtype)
        if layout == "contiguous":
            t = x[:size].view(B, S, H, D)
        elif layout == "transposed":
            t = x[:size].view(B, H, S, D).transpose(1, 2)
        else:
            t = x[1:].view(B, S, H, D)
        out.append(t)
    return out


def _lse_delta(q):
    B, S, H, _ = q.shape
    rng = np.random.default_rng(7)
    return (torch.tensor(rng.standard_normal((B, H, S)), dtype=torch.float32)
            for _ in range(2))


@pytest.mark.parametrize("layout", ["contiguous", "transposed", "offset"])
@pytest.mark.parametrize("D", [16, 32, 64, 100, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_variant_rule(dtype, D, layout):
    q, k, v, do = _tensors(dtype, D, layout)
    assert q.stride(-1) == 1
    aligned = layout != "offset"
    if dtype == torch.float32:
        want = "fma"
    elif D % 8 == 0 and aligned:
        want = "tma"
    else:
        want = "mma"
    assert fa._bwd_variant(q, k, v, do) == want
    takes = {var for var in fa._BWD_VARIANTS
             if fa._bwd_takes(var, q, k, v, do)}
    assert takes == ({"fma"} if dtype == torch.float32
                     else {"mma", "tma"} if want == "tma" else {"mma"})


@pytest.mark.parametrize("which", [0, 1, 2, 3])
def test_one_misaligned_input_leaves_tma(which):
    """The rule looks at q, k, v and dO alike: one unaligned input sends
    the call to the mma.sync kernels."""
    ts = _tensors(torch.bfloat16, 64, "contiguous")
    ts[which] = _tensors(torch.bfloat16, 64, "offset", n=1)[0]
    assert fa._bwd_variant(*ts) == "mma"
    good = _tensors(torch.bfloat16, 64, "contiguous")
    assert fa._bwd_variant(*good) == "tma"


def test_transposed_do_is_passed_as_it_lies():
    """A non-contiguous dO whose rows a TMA map takes (a [B, H, S, D]
    buffer seen as [B, S, H, D]) is not copied: its strides go to the
    kernel."""
    q, k, v = _tensors(torch.bfloat16, 64, "contiguous", n=3)
    (do,) = _tensors(torch.bfloat16, 64, "transposed", n=1, seed=3)
    assert not do.is_contiguous()
    lse, delta = _lse_delta(q)
    out = fa._bwd_args(q, k, v, do, lse, delta)
    assert out[3].data_ptr() == do.data_ptr()
    assert out[3].stride() == do.stride()
    assert fa._bwd_variant(*out[:4]) == "tma"


@pytest.mark.parametrize("kind", ["expanded_zero", "offset"])
def test_do_no_map_takes_is_copied_for_tma(kind):
    """An expanded zero (strides 0) or a dO off 16 bytes: the rule on the
    raw dO says "mma", so the wrapper copies dO contiguous where q, k and
    v take the TMA kernels, and the call goes to "tma" with dO's values
    unchanged."""
    q, k, v = _tensors(torch.bfloat16, 64, "contiguous", n=3)
    if kind == "expanded_zero":
        do = torch.zeros((1, 1, 1, 64), dtype=torch.bfloat16).expand(q.shape)
        assert do.stride()[:3] == (0, 0, 0)
    else:
        (do,) = _tensors(torch.bfloat16, 64, "offset", n=1, seed=4)
        assert do.is_contiguous()
    assert fa._bwd_variant(q, k, v, do) == "mma"
    lse, delta = _lse_delta(q)
    q2, k2, v2, do2, lse2, delta2 = fa._bwd_args(q, k, v, do, lse, delta)
    assert do2.is_contiguous() and do2.data_ptr() != do.data_ptr()
    assert fa._tma_ready(do2) and torch.equal(do2, do)
    assert fa._bwd_variant(q2, k2, v2, do2) == "tma"


def test_do_is_not_copied_when_q_leaves_tma():
    """Where q, k or v already send the call to "mma", dO is left as it
    is: the copy would buy nothing."""
    (q,) = _tensors(torch.bfloat16, 64, "offset", n=1)
    k, v = _tensors(torch.bfloat16, 64, "contiguous", n=2)
    do = torch.zeros((1, 1, 1, 64), dtype=torch.bfloat16).expand(q.shape)
    lse, delta = _lse_delta(q)
    out = fa._bwd_args(q, k, v, do, lse, delta)
    assert out[3].data_ptr() == do.data_ptr()
    assert fa._bwd_variant(*out[:4]) == "mma"


@pytest.mark.parametrize("wrapper", ["flash_bwd_dq_cuda",
                                     "flash_bwd_dkv_cuda"])
@pytest.mark.parametrize("variant,dtype,D,layout", [
    ("tma", torch.float32, 64, "contiguous"),    # bf16 only
    ("tma", torch.bfloat16, 100, "contiguous"),  # D % 8 != 0
    ("tma", torch.bfloat16, 64, "offset"),       # rows not 16-byte aligned
    ("mma", torch.float32, 64, "contiguous"),
    ("fma", torch.bfloat16, 64, "contiguous"),
    ("wgmma", torch.bfloat16, 64, "contiguous"),  # no such variant
])
def test_forced_variant_that_cannot_take_raises_before_launch(
        wrapper, variant, dtype, D, layout):
    q, k, v, do = _tensors(dtype, D, layout)
    lse, delta = _lse_delta(q)
    before = _counts()
    with pytest.raises(ValueError, match=f"variant {variant!r} does not "
                                         f"take"):
        getattr(fa, wrapper)(q, k, v, do, lse, delta, "diag", D ** -0.5,
                             variant=variant)
    assert _counts() == before


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("mode", fa.MODES)
def test_cpu_tensors_take_the_plain_backward(dtype, mode):
    """flash_attention_lse with autograd on CPU tensors: the gradients are
    the plain backward's on the same inputs, bit for bit, and no kernel
    count moves."""
    q, k, v, do = _tensors(dtype, 64, "contiguous", S=40)
    dlse = torch.tensor(np.random.default_rng(2).standard_normal((2, 3, 40)),
                        dtype=torch.float32)
    before = _counts()
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    o, lse = fa.flash_attention_lse(qg, kg, vg, mode=mode, block=16)
    got = torch.autograd.grad((o, lse), (qg, kg, vg), (do, dlse))
    o, lse = o.detach(), lse.detach()
    delta = ((do.float() * o.float()).sum(-1).transpose(1, 2)
             - dlse).contiguous()
    want = fa._flash_bwd_plain(q, k, v, o, lse, do, delta, mode, 64 ** -0.5,
                               fa._validate(q, k, v, 16))
    for a, b in zip(got, want):
        assert a.dtype == dtype and torch.equal(a, b)
    assert _counts() == before
