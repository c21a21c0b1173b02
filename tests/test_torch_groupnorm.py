"""The ConvGN epilogue (ops/groupnorm.py): the plain composition against
ConvGN.conv_gn, the rule that picks the path, the wrapper's input
checks and, on a card, the CUDA kernels (csrc/convgn.cu) against the plain
composition. This file imports no JAX, so that the card's tests run where
JAX is not installed:

    python -m pytest --noconftest -q -m cuda tests/test_torch_groupnorm.py

Without a card the `cuda` tests skip; the others run anywhere.
"""

import importlib.util
import math
import pathlib

import pytest
import torch
import torch.nn.functional as F

from sbb_textline_detection_tpu_torch.models import checkpoint, registry, unet
from sbb_textline_detection_tpu_torch.ops import groupnorm

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _chip_smoke():
    """chip_smoke.py (its block shapes, inputs, checks and limits) as a
    module, loaded by path: the repository's root is no package."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_for_tests", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _chip_smoke()
# the page model's one tile (the served chunk is chip_smoke.CONVGN_N)
PAGE_N = 1
BLOCKS = SMOKE.convgn_block_shapes(registry.FLAGSHIP_WIDTHS, 32,
                                   SMOKE.CONVGN_SIDE)


def _block(in_ch, features, stride, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    block = unet.ConvGN(in_ch, features, stride, dtype)
    with torch.no_grad():
        block.conv.weight.copy_(torch.randn(block.conv.weight.shape,
                                            generator=gen) * 0.2)
        block.norm.weight.copy_(1 + 0.1 * torch.randn(features,
                                                      generator=gen))
        block.norm.bias.copy_(0.1 * torch.randn(features, generator=gen))
    x = torch.rand((2, in_ch, 12, 12), generator=gen) + 0.25 * torch.randn(
        (2, in_ch, 12, 12), generator=gen)
    return block, x.to(dtype).contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("in_ch,features,stride", [
    (3, 32, 2), (32, 32, 1), (64, 64, 1), (256, 256, 1), (512, 512, 1)],
    ids=["stem", "c32", "c64", "c256", "c512"])
def test_plain_epilogue_equals_the_convgn_composition(in_ch, features,
                                                      stride, dtype):
    """On the CPU the block, and epilogue_plain on its conv's sum, give
    what ConvGN.conv_gn (the float32 GroupNorm that unet.trace_blocks
    records) gives through GELU and the cast, bit for bit and in the same
    memory layout."""
    block, x = _block(in_ch, features, stride, dtype, seed=features + stride)
    want = F.gelu(block.conv_gn(x), approximate="tanh").to(dtype)
    y = block.conv_sum(block.pad(x))
    for got in (block(x), groupnorm.epilogue_plain(y, block.norm, dtype),
                groupnorm.epilogue(y, block.norm, dtype)):
        assert got.dtype == dtype
        assert got.is_contiguous(memory_format=torch.channels_last)
        assert torch.equal(got, want)
    with torch.no_grad():
        assert torch.equal(block(x), want)


def test_selection_reads_device_and_gradient():
    """The kernels for a CUDA forward that records no gradient; the plain
    composition on the CPU, and wherever autograd records the call."""
    assert groupnorm.uses_kernels(torch.device("cuda", 0), grad=False)
    assert not groupnorm.uses_kernels(torch.device("cuda", 0), grad=True)
    assert not groupnorm.uses_kernels(torch.device("cpu"), grad=False)
    assert not groupnorm.uses_kernels(torch.device("cpu"), grad=True)
    block, x = _block(8, 8, 1, torch.bfloat16, seed=0)
    y = block.conv_sum(block.pad(x))
    assert groupnorm.records_grad(y, block.norm)        # a training step
    with torch.no_grad():
        y0 = block.conv_sum(block.pad(x))
        assert not groupnorm.records_grad(y0, block.norm)
    with torch.inference_mode():
        assert not groupnorm.records_grad(y0, block.norm)
    block.requires_grad_(False)                         # frozen, grad on
    assert not groupnorm.records_grad(y0, block.norm)
    assert groupnorm.records_grad(y0.requires_grad_(), block.norm)


@pytest.mark.parametrize("grad", [False, True], ids=["no_grad", "grad"])
def test_cpu_forward_takes_the_plain_path(monkeypatch, grad):
    """A CPU TpuUnet forward, served or trained, never reaches the
    kernels' wrapper, and a trained one still back-propagates."""
    def refuse(*args, **kwargs):
        raise AssertionError("the kernels' wrapper was called on the CPU")

    monkeypatch.setattr(groupnorm, "convgn_cuda", refuse)
    model = unet.TpuUnet(2, (4, 8), refine_width=4)
    x = torch.rand((1, 16, 16, 3), generator=torch.Generator().manual_seed(3))
    with torch.set_grad_enabled(grad):
        out = model(x)
    assert out.shape == (1, 16, 16, 2)
    if grad:
        out.sum().backward()
        assert model.stem.norm.weight.grad is not None


def _bad(shape=(1, 8, 3, 3), dtype=torch.float32, channels_last=True):
    y = torch.zeros(shape, dtype=dtype)
    return y.contiguous(memory_format=torch.channels_last) \
        if channels_last else y


@pytest.mark.parametrize("y,groups,dtype,weight,match", [
    (_bad(dtype=torch.float16), 8, torch.bfloat16, None, "float32"),
    (_bad()[0], 8, torch.bfloat16, None, "float32"),
    (_bad(), 8, torch.float16, None, "compute dtype"),
    (_bad((1, 6, 3, 3)), 6, torch.bfloat16, None, "multiple of 4"),
    (_bad((1, 1028, 1, 2)), 4, torch.bfloat16, None, "multiple of 4"),
    (_bad(), 3, torch.bfloat16, None, "groups"),
    (_bad(channels_last=False), 8, torch.bfloat16, None, "channels_last"),
    (_bad((1, 8, 3, 6))[..., ::2], 8, torch.bfloat16, None, "channels_last"),
    (_bad(), 8, torch.bfloat16, torch.ones(4), "weight"),
    (_bad(), 8, torch.bfloat16, torch.ones(8, dtype=torch.bfloat16),
     "weight"),
    (_bad(), 8, torch.bfloat16, None, "CUDA tensor"),
], ids=["half_sum", "three_dims", "half_compute", "six_channels",
        "too_many_channels", "uneven_groups", "nchw", "strided",
        "weight_shape", "weight_dtype", "cpu"])
def test_wrapper_rejects_what_the_kernels_do_not_take(y, groups, dtype,
                                                       weight, match):
    c = y.shape[1] if y.ndim == 4 else 8
    w = torch.ones(c) if weight is None else weight
    with pytest.raises(ValueError, match=match):
        groupnorm.convgn_cuda(y, w, torch.zeros(c), 1e-6, groups, dtype)


@pytest.mark.parametrize("side", [32, 64])
def test_block_shapes_follow_the_model(side):
    """chip_smoke.convgn_block_shapes, at which the card's tests and the
    smoke's convgn phase run, are the ConvGN outputs of a flagship-width
    TpuUnet."""
    model = unet.TpuUnet(2, registry.FLAGSHIP_WIDTHS, refine_width=32)
    seen = []
    hooks = [b.register_forward_hook(
        lambda mod, args, out, name=name: seen.append(
            (name, out.shape[1], out.shape[2])))
        for name, b in model.named_modules() if isinstance(b, unet.ConvGN)]
    with torch.no_grad():
        model(torch.rand((1, side, side, 3)))
    for h in hooks:
        h.remove()
    assert seen == SMOKE.convgn_block_shapes(registry.FLAGSHIP_WIDTHS, 32,
                                             side)
    assert len(seen) == 28


def test_smoke_holds_a_served_run_to_two_launches_a_convgn(monkeypatch):
    """chip_smoke._served_run counts a served run's ConvGN forwards and
    fails the run unless it launched the two convgn kernels for each: a
    forward on the plain composition fails, one whose epilogues count two
    launches passes and adds both counts to the smoke's total."""
    monkeypatch.setattr(SMOKE, "SERVED_CONVGN",
                        {"launches": 0, "forwards": 0})
    model = unet.TpuUnet(2, (4, 8), refine_width=4).eval()
    x = torch.rand((1, 16, 16, 3), generator=torch.Generator().manual_seed(5))
    with pytest.raises(AssertionError, match="0 convgn kernels for 16"):
        with SMOKE._served_run(), torch.no_grad():
            model(x)
    real = groupnorm.epilogue_plain

    def counted(y, norm, dtype):
        groupnorm.launches += 2
        return real(y, norm, dtype)

    monkeypatch.setattr(groupnorm, "epilogue_plain", counted)
    with SMOKE._served_run(), torch.no_grad():
        model(x)
        model(x)
    assert SMOKE.SERVED_CONVGN == {"launches": 64, "forwards": 48}


# ---------------------------------------------------------------------------
# on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [SMOKE.CONVGN_N, PAGE_N], ids=["chunk", "page"])
@pytest.mark.parametrize("name,c,side", BLOCKS, ids=[b[0] for b in BLOCKS])
def test_kernels_match_plain_on_card(cuda_device, name, c, side, n):
    """Each of the 28 block shapes, at the served chunk of 54 tiles and at
    the page model's one, within chip_smoke.convgn_within's limits
    (statistics within 1e-6 of float64's; bf16 outputs that differ from
    the plain composition's on at most 0.1 % of the elements, by 1 ulp
    away from zero); the output channels_last; a second launch the same
    bit for bit."""
    with torch.no_grad():
        y = SMOKE.conv_sum_like(n, c, side, c + side + n, cuda_device)
        norm = SMOKE.convgn_norm_like(c, c, cuda_device)
        first, _, row = SMOKE.convgn_check(y, norm, torch.bfloat16)
        second = groupnorm.convgn_cuda(y, norm.weight, norm.bias, norm.eps,
                                       norm.num_groups, torch.bfloat16,
                                       stats=True)
        torch.cuda.synchronize()
    print(f"{name} n={n}: {row}")
    assert first[0].is_contiguous(memory_format=torch.channels_last)
    assert SMOKE.convgn_within(row), row
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("name,c,side", [BLOCKS[0], BLOCKS[14], BLOCKS[-1]],
                         ids=["stem", "middle", "refine"])
def test_float32_kernels_match_plain_on_card(cuda_device, name, c, side):
    """In float32 compute the statistics come from the sum itself and the
    output stays float32."""
    with torch.no_grad():
        y = SMOKE.conv_sum_like(SMOKE.CONVGN_N, c, side, c, cuda_device)
        norm = SMOKE.convgn_norm_like(c, c, cuda_device)
        (out, _, _), plain, row = SMOKE.convgn_check(y, norm, torch.float32)
    assert out.dtype == torch.float32
    limit = SMOKE.CONVGN_STAT_RTOL
    assert row["mean_err"] <= limit and row["mul_err"] <= limit, row
    torch.testing.assert_close(out, plain, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_threads_on_one_stream_share_the_tickets_on_card(cuda_device):
    """Threads that launch the kernels at once on the same stream (the
    batch's device-phase workers) share that stream's ticket counters:
    each thread's outputs equal the same launches made alone, bit for
    bit, and the count of launches is exact."""
    import sys
    import threading

    shapes = [BLOCKS[0], BLOCKS[14], BLOCKS[-2], BLOCKS[5]]
    with torch.no_grad():
        cases = []
        for i, (_, c, side) in enumerate(shapes):
            y = SMOKE.conv_sum_like(8, c, side, 100 + i, cuda_device)
            norm = SMOKE.convgn_norm_like(c, 100 + i, cuda_device)
            args = (y, norm.weight, norm.bias, norm.eps, norm.num_groups,
                    torch.bfloat16)
            cases.append((args, groupnorm.convgn_cuda(*args)))
        torch.cuda.synchronize()
        rounds = 20
        got = [[] for _ in cases]
        errors = []

        def work(i):
            try:
                with torch.no_grad():
                    for _ in range(rounds):
                        got[i].append(groupnorm.convgn_cuda(*cases[i][0]))
            except Exception as exc:        # reported below
                errors.append(exc)

        before = groupnorm.launches
        switch = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            threads = [threading.Thread(target=work, args=(i,))
                       for i in range(len(cases))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
        finally:
            sys.setswitchinterval(switch)
        assert not any(t.is_alive() for t in threads)
        torch.cuda.synchronize()
    assert not errors, errors
    assert groupnorm.launches - before == 2 * rounds * len(cases)
    for (_, want), outs in zip(cases, got):
        assert len(outs) == rounds
        assert all(torch.equal(o, want) for o in outs)


@pytest.mark.cuda
def test_dualhead_forward_kernels_match_plain_on_card(cuda_device,
                                                      monkeypatch):
    """A random-init bf16 dual-head forward launches two kernels a ConvGN
    and agrees with the plain composition's forward in each head's
    argmax at chip_smoke.BF16_ARGMAX_AGREE or better."""
    spec = registry.DUALHEAD_SPEC
    sd = checkpoint.random_init(spec, torch.Generator().manual_seed(0))
    model = registry.build_module(spec, torch.bfloat16)
    model.load_state_dict(sd)
    model = model.to(cuda_device).eval()
    side = SMOKE.CONVGN_SIDE
    x = torch.rand((4, side, side, 2), generator=torch.Generator()
                   .manual_seed(1)).to(cuda_device)
    with torch.no_grad():
        before = groupnorm.launches
        fast = model(x)
        torch.cuda.synchronize()
        assert groupnorm.launches - before == 2 * 28
        monkeypatch.setattr(groupnorm, "uses_kernels", lambda *a: False)
        plain = model(x)
        assert groupnorm.launches - before == 2 * 28
    agree, off = [], 0
    for width in spec.heads:
        agree.append(float((fast[..., off:off + width].argmax(-1)
                            == plain[..., off:off + width].argmax(-1))
                           .float().mean()))
        off += width
    print(f"argmax agreement by head: {agree}")
    assert min(agree) >= SMOKE.BF16_ARGMAX_AGREE, agree
    assert math.isfinite(float(fast.abs().max()))
