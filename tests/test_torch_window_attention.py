"""The fused window attention's plain version and wrapper on the CPU
(``vsrlab_tpu_torch/ops/window_attention.py``).

The plain version is held against an independent float64 einsum of
windowed attention with the relative-position bias and type-indexed shift
masks, at the shapes its callers give it (self attention, a mutual
direction's halves, ``forward_rows``' rows, ragged sizes, strided views of
a qkv projection's output, an output slice of a wider buffer). Gate: 2e-6
of the largest |v|, the fp32 logits' and softmax's rounding (the float64
einsum rounds nothing). The kernel itself is held against the plain
version on the card (``tests/test_torch_cuda.py``), at the bf16 gate of
``tests/_attention_gate.py``, which a float64 emulation of the kernel's
rounding points passes here and the same with bf16 logits fails.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _attention_gate import QK_STD, bf16_gate_ratios, emulate_kernel  # noqa: E402
from vsrlab_tpu_torch.models.vrt import window_attention as wa  # noqa: E402
from vsrlab_tpu_torch.ops import window_attention as owa  # noqa: E402

# (windows, heads, nq, nk, hd, bias, masks, types): N 32 self attention with
# both, a mutual direction's halves (masks, no bias), forward_rows' rows
# (nq < nk), neither, ragged sizes and VRT's head dims
CASES = [
    (5, 3, 32, 32, 8, True, True, 4),
    (4, 2, 16, 16, 20, False, True, 2),
    (3, 2, 12, 36, 30, True, True, 8),
    (6, 1, 9, 9, 4, False, False, 0),
    (2, 4, 7, 13, 6, True, False, 0),
]


def _einsum_attention(q, k, v, scale, bias, masks, tid):
    """float64 windowed attention, written independently of the port."""
    q, k, v = (t.double() for t in (q, k, v))
    logits = torch.einsum("bhqd,bhkd->bhqk", q * scale, k)
    if bias is not None:
        logits = logits + bias.double()[None]
    if masks is not None:
        logits = logits + torch.stack([masks.double()[int(t)] for t in tid])[:, None]
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bqhd", p, v)
    return out.reshape(out.shape[0], out.shape[1], -1)


def _operands(case, seed=0):
    b, h, nq, nk, hd, with_bias, with_masks, types = case
    g = torch.Generator().manual_seed(seed)
    # q, k, v as the heads of one fused projection's output (B, n, 3 * H * hd)
    n = max(nq, nk)
    qkv = torch.randn((b, n, 3 * h * hd), generator=g)

    def heads(t, rows):
        return t[:, :rows].reshape(b, rows, h, hd).transpose(1, 2)

    q, k, v = (heads(t, r) for t, r in zip(qkv.chunk(3, -1), (nq, nk, nk)))
    bias = (torch.rand((h, nq, nk), generator=g) * 0.08 - 0.04) if with_bias else None
    masks = tid = None
    if with_masks:
        masks = torch.where(torch.rand((types, nq, nk), generator=g) < 0.3, -100.0, 0.0)
        tid = torch.randint(0, types, (b,), generator=g)
    return q, k, v, hd ** -0.5, bias, masks, tid


@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_plain_version_matches_an_independent_einsum(monkeypatch, case, chunked):
    q, k, v, scale, bias, masks, tid = _operands(case)
    if chunked:  # two windows a chunk
        monkeypatch.setattr(owa, "LOGITS_BUDGET", 2 * q.shape[1] * q.shape[2] * k.shape[2] * 4)
    got = owa.window_attention_plain(q, k, v, scale, bias, masks, tid)
    want = _einsum_attention(q, k, v, scale, bias, masks, tid)
    assert got.shape == (q.shape[0], q.shape[2], q.shape[1] * q.shape[3])
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=2e-6 * v.abs().max().item())


@pytest.mark.parametrize("case", CASES)
def test_cpu_tensor_takes_the_plain_path_and_counts_no_launch(monkeypatch, case):
    q, k, v, scale, bias, masks, tid = _operands(case, seed=1)

    def no_launch(*args, **kwargs):
        raise AssertionError("a CPU tensor reached the kernel launch")

    monkeypatch.setattr(owa, "_launch", no_launch)
    before = owa.window_attention.launches
    got = owa.window_attention(q, k, v, scale, bias, masks, tid)
    assert owa.window_attention.launches == before
    torch.testing.assert_close(got, owa.window_attention_plain(q, k, v, scale, bias, masks, tid),
                               rtol=0, atol=0)
    # written into a channel slice of a wider buffer, the rest untouched
    b, h, nq, hd = q.shape
    buf = torch.full((b, nq, 3 * h * hd), 7.0)
    ret = owa.window_attention(q, k, v, scale, bias, masks, tid, out=buf[:, :, h * hd:2 * h * hd])
    assert ret.data_ptr() == buf[:, :, h * hd:].data_ptr()
    torch.testing.assert_close(buf[:, :, h * hd:2 * h * hd], got, rtol=0, atol=0)
    assert bool((buf[:, :, :h * hd] == 7.0).all()) and bool((buf[:, :, 2 * h * hd:] == 7.0).all())


@pytest.mark.parametrize("case", CASES[:3])
def test_fused_attention_backward_is_autograd_through_the_plain_version(monkeypatch, case):
    """The autograd Function the card runs, with its launch replaced by the
    plain version (counted): its gradients are the plain version's."""
    q, k, v, scale, bias, masks, tid = _operands(case, seed=2)
    calls = []

    def plain_launch(q, k, v, scale, bias, masks, tid, out=None):
        calls.append(q.shape)
        return owa.window_attention_plain(q, k, v, scale, bias, masks, tid)

    monkeypatch.setattr(owa, "_launch", plain_launch)
    leaves = [t.detach().clone().requires_grad_() if t is not None else None
              for t in (q, k, v, bias)]
    got = owa.FusedAttention.apply(*leaves, masks, tid, scale)
    g = torch.randn(got.shape, generator=torch.Generator().manual_seed(3))
    got.backward(g)
    refs = [t.detach().clone().requires_grad_() if t is not None else None
            for t in (q, k, v, bias)]
    want = owa.window_attention_plain(*refs[:3], scale, refs[3], masks, tid)
    want.backward(g)
    assert len(calls) == 1
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    for a, r in zip(leaves, refs):
        if a is not None:
            torch.testing.assert_close(a.grad, r.grad, rtol=0, atol=0)


def test_wrapper_refuses_mismatched_shapes():
    q, k, v, scale, bias, masks, tid = _operands(CASES[0])
    cases = [
        dict(q=q[0]),                                  # not 4-D
        dict(k=k[:, :, :-1], v=v),                     # k and v differ
        dict(k=k[:, :1], v=v[:, :1]),                  # heads differ
        dict(bias=bias[:, :-1]),                       # bias rows
        dict(masks=masks[:, :, :-1]),                  # mask columns
        dict(masks=masks, tid=None),                   # masks without types
        dict(tid=tid[:-1]),                            # a type a window
        dict(out=torch.empty(1, 2, 3)),                # output shape
    ]
    base = dict(q=q, k=k, v=v, bias=bias, masks=masks, tid=tid)
    for case in cases:
        args = {**base, **case}
        with pytest.raises(ValueError):
            owa.window_attention(args["q"], args["k"], args["v"], scale, args["bias"],
                                 args["masks"], args["tid"], out=args.get("out"))


@pytest.mark.parametrize("mut_attn", [True, False])
def test_module_writes_mutual_and_self_into_their_slices(mut_attn):
    """WindowAttention's pre-projection buffer: ``[mutual, self]`` on
    channels, each part the wrapper's result on the module's own q, k, v."""
    torch.manual_seed(0)
    dim, heads, ws = 12, 3, (2, 2, 4)
    mod = wa.WindowAttention(dim, ws, heads, mut_attn=mut_attn)
    mask = wa.compute_mask_factored(4, 4, 8, ws, (1, 1, 2))
    b, n = len(mask.type_ids) * 2, 16
    x = torch.randn(b, n, dim)
    pre = []
    mod.proj.register_forward_hook(lambda m, args, out: pre.append(args[0]))
    mod(x, mask)
    hd, half = dim // heads, n // 2

    def heads_of(t):
        return t.reshape(b, n, heads, hd).transpose(1, 2)

    q, k, v = (heads_of(t) for t in mod.qkv_self(x).chunk(3, -1))
    rpi = mod.rpi[:n, :n].reshape(-1)
    bias = mod.relative_position_bias_table[rpi].reshape(n, n, heads).permute(2, 0, 1)
    masks = torch.from_numpy(mask.masks)
    tid = torch.from_numpy(mask.type_ids).long().repeat(2)
    want_self = owa.window_attention_plain(q, k, v, mod.scale, bias, masks, tid)
    got = pre[0]
    assert got.shape == (b, n, (2 if mut_attn else 1) * dim)
    torch.testing.assert_close(got[..., -dim:], want_self, rtol=0, atol=0)
    if mut_attn:
        qm, km, vm = (heads_of(t) for t in mod.qkv_mut(x + mod.pos2).chunk(3, -1))
        m = masks[:, :half, :half]
        x1 = owa.window_attention_plain(qm[:, :, half:], km[:, :, :half], vm[:, :, :half],
                                        mod.scale, None, m, tid)
        x2 = owa.window_attention_plain(qm[:, :, :half], km[:, :, half:], vm[:, :, half:],
                                        mod.scale, None, m, tid)
        torch.testing.assert_close(got[..., :dim], torch.cat([x1, x2], 1), rtol=0, atol=0)


@pytest.mark.parametrize("case", [CASES[0], CASES[3]])
def test_custom_op_passes_opcheck(case):
    q, k, v, scale, bias, masks, tid = _operands(case, seed=4)
    torch.library.opcheck(owa._attention_op, (q, k, v, scale, bias, masks, tid))


def test_exported_window_attention_calls_the_custom_op():
    """A WindowAttention exported with ``torch.export`` keeps the attention
    as ``vsrlab::window_attention`` (what the program runs on the card) and
    computes what the eager module does."""
    torch.manual_seed(0)
    mod = wa.WindowAttention(12, (2, 2, 4), 3, mut_attn=True).eval()
    mask = wa.compute_mask_factored(4, 4, 8, (2, 2, 4), (1, 1, 2))

    class Shifted(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.attn = mod

        def forward(self, x):
            return self.attn(x, mask)

    x = torch.randn(len(mask.type_ids), 16, 12)
    with torch.no_grad():
        program = torch.export.export(Shifted(), (x,), strict=False)
        graph = str(program.graph)
        assert graph.count("vsrlab.window_attention") == 3  # two mutual directions, self
        torch.testing.assert_close(program.module()(x), Shifted()(x), rtol=0, atol=0)


# the cases of the card's kernel test (windows, heads, nq, nk, hd, bias, masks):
# self attention at N 384 and 128, a mutual direction, forward_rows' rows, the
# small dims, ragged sizes, the widest head
GATE_CASES = [
    (6, 6, 384, 384, 20, True, True),
    (8, 6, 128, 128, 20, True, True),
    (8, 6, 64, 64, 30, False, True),
    (4, 6, 128, 384, 20, True, True),
    (9, 2, 32, 32, 4, True, True),
    (5, 3, 50, 77, 12, True, True),
    (4, 2, 128, 128, 64, True, True),
]


def _gate_operands(case, seed):
    b, h, nq, nk, hd, with_bias, with_masks = case
    g = torch.Generator().manual_seed(seed)
    n = max(nq, nk)
    qkv = torch.randn((b, n, 3 * h * hd), generator=g)
    qkv[..., :2 * h * hd] *= QK_STD
    qkv = qkv.to(torch.bfloat16)

    def heads(t, rows):
        return t[:, :rows].reshape(b, rows, h, hd).transpose(1, 2)

    q, k, v = (heads(t, r) for t, r in zip(qkv.chunk(3, -1), (nq, nk, nk)))
    bias = (torch.rand((h, nq, nk), generator=g) - 0.5) if with_bias else None
    masks = tid = None
    if with_masks:
        masks = torch.where(torch.rand((8, nq, nk), generator=g) < 0.3, -100.0, 0.0)
        tid = torch.randint(0, 8, (b,), generator=g)
    return q, k, v, hd ** -0.5, bias, masks, tid


@pytest.mark.parametrize("case", GATE_CASES, ids=[f"{c[2]}x{c[3]}_hd{c[4]}" for c in GATE_CASES])
def test_bf16_gate_passes_the_kernels_rounding_and_refuses_bf16_logits(case):
    """The card test's bf16 gate against the plain version (bf16 on the
    CPU): the kernel's rounding points, emulated in float64, pass it with
    room (under 0.8 of each bound); the same arithmetic with the logits
    rounded to bf16, below the configuration's precision, fails it."""
    for seed in range(2):
        ops = _gate_operands(case, seed)
        want = owa.window_attention_plain(*ops)
        elem, rms = bf16_gate_ratios(emulate_kernel(*ops), want)
        assert elem <= 0.8 and rms <= 0.8, (elem, rms)
        elem, rms = bf16_gate_ratios(emulate_kernel(*ops, logits_bf16=True), want)
        assert elem > 1 or rms > 1, (elem, rms)
