"""The optimizer updates (ops/fused_optim.py, csrc/fused_optim.cu) on the CPU:
CPU tensors take the plain loops and launch nothing; the multi-tensor
kernels' chunk plan for the paper's G (164 leaves) and D (64 leaves), their
tables' key and leaf limit, and their constants against the CUDA source;
the loaders and the
checkpoint restore writing into the optimizer's own moment tensors, which
the kernels' tables point to.  The kernels themselves are held against the
plain loops on the card (tests/test_torch_port_cuda.py)."""

import copy
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from multi_stylegan_torch.io import from_jax, reference
from multi_stylegan_torch.io.checkpoint import (
    CheckpointManager,
    load_train_state,
    train_state_dict,
)
from multi_stylegan_torch.models.config import (
    DiscriminatorConfig,
    GeneratorConfig,
    TrainingConfig,
    tiny_discriminator_config,
    tiny_generator_config,
)
from multi_stylegan_torch.models.discriminator import Discriminator
from multi_stylegan_torch.models.generator import Generator
from multi_stylegan_torch.ops import fused_optim
from multi_stylegan_torch.train.ema import ema_update
from multi_stylegan_torch.train.state import ClippedAdam, create_train_state
from multi_stylegan_torch.utils import profiling

SOURCE = Path(fused_optim.__file__).resolve().parent.parent / "csrc" / "fused_optim.cu"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs several worker processes on a few
    cores, and more threads only oversubscribe them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tiny_state(seed=0):
    """The tiny config's state, its weights drawn from ``seed`` (a module's
    constructor leaves them unset)."""
    gen = Generator(tiny_generator_config())
    disc = Discriminator(tiny_discriminator_config())
    gen.reset_parameters(torch.Generator().manual_seed(seed))
    disc.reset_parameters(torch.Generator().manual_seed(seed + 1))
    return create_train_state(gen, disc, TrainingConfig())


def _grads(opt, seed, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(p.shape, generator=g) * scale for p in opt.params]


@pytest.fixture(scope="module")
def paper_leaves():
    """The paper's G and D leaf sizes (default configs), on the meta device:
    shapes without memory."""
    gen = Generator(GeneratorConfig(), device="meta")
    disc = Discriminator(DiscriminatorConfig(), device="meta")
    return {"G": [p.numel() for p in gen.parameters()],
            "D": [p.numel() for p in disc.parameters()]}


# ----------------------------------------------------------- the plain path


def test_cpu_tensors_take_the_plain_loops_and_launch_nothing():
    state = _tiny_state()
    adam0, ema0 = fused_optim.adam_launches, fused_optim.ema_launches
    moments = [id(m) for m in state.g_opt.exp_avg + state.g_opt.exp_avg_sq]
    count = state.g_opt.count
    before = [p.detach().clone() for p in state.generator.parameters()]
    applied = state.g_opt.step(_grads(state.g_opt, 1))
    ema_update(state.g_ema, state.generator, 0.999)
    assert bool(applied) and int(state.g_opt.count) == 1
    assert any(not torch.equal(a, b) for a, b in zip(before, state.generator.parameters()))
    assert (fused_optim.adam_launches, fused_optim.ema_launches) == (adam0, ema0)
    assert state.g_opt.tables is None
    # the plain loop updates in place, as the kernels do
    assert [id(m) for m in state.g_opt.exp_avg + state.g_opt.exp_avg_sq] == moments
    assert state.g_opt.count is count


def test_plain_step_is_the_per_leaf_formula():
    """One plain step against the formula written out leaf by leaf: the
    joint clip (fires at ||g|| >= max_norm, no eps), b1 0.9, two lr groups,
    a None gradient as zero."""
    a, b = torch.nn.Parameter(torch.randn(3, 4)), torch.nn.Parameter(torch.randn(5))
    opt = ClippedAdam([([a], 1e-2), ([b], 1e-4)], b1=0.9, b2=0.999, max_norm=1.0)
    p0 = [a.detach().clone(), b.detach().clone()]
    g = torch.randn(3, 4) * 3
    opt.step([g, None])
    norm = g.square().sum().sqrt()
    gc = g / norm * 1.0
    mu, nu = 0.1 * gc, 0.001 * gc.square()
    want = p0[0] - 1e-2 * ((mu / 0.1) / ((nu / (1 - 0.999)).sqrt() + 1e-8))
    torch.testing.assert_close(a.detach(), want, rtol=1e-6, atol=1e-7)
    assert torch.equal(b.detach(), p0[1])  # zero gradient: m = v = 0, no move
    torch.testing.assert_close(opt.exp_avg[0], mu)


def test_plain_step_skips_a_nonfinite_gradient_and_forces_after_the_limit():
    a = torch.nn.Parameter(torch.randn(6))
    opt = ClippedAdam([([a], 1e-3)], max_consecutive_nonfinite=2)
    opt.step([torch.randn(6)])
    p1, m1, count = a.detach().clone(), opt.exp_avg[0].clone(), int(opt.count)
    bad = torch.randn(6)
    bad[2] = float("nan")
    for k in (1, 2):
        assert not bool(opt.step([bad]))
        assert torch.equal(a.detach(), p1) and torch.equal(opt.exp_avg[0], m1)
        assert int(opt.count) == count and int(opt.notfinite_count) == k
    assert bool(opt.step([bad]))  # the third in a row is applied anyway
    assert int(opt.count) == count + 1 and int(opt.notfinite_count) == 3


def test_train_adam_span_names_the_path():
    state = _tiny_state()
    profiling.clear_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        state.d_opt.step(_grads(state.d_opt, 2))
        ema_update(state.g_ema, state.generator)
    got = {s.name: s.attrs for s in profiling.spans()}
    profiling.clear_spans()
    assert got["train.adam"] == {"leaves": len(state.d_opt.params), "fused": False}
    assert got["train.ema"] == {"fused": False}


def test_other_devices_are_refused():
    p = torch.nn.Parameter(torch.zeros(4, device="meta"))
    opt = ClippedAdam([([p], 1e-3)])
    with pytest.raises(ValueError, match="unsupported device meta"):
        opt.step([None])
    with pytest.raises(ValueError, match="unsupported device meta"):
        fused_optim.ema_update([torch.zeros(4, device="meta")], [p], 0.999)


# ------------------------------------------------------------ the kernels' plan


def _check_plan(numels, chunks, chunk):
    assert chunks.dtype == np.int32 and chunks.flags.c_contiguous
    # every value of every leaf in exactly one chunk, the chunks in leaf order
    covered = np.zeros(len(numels), np.int64)
    for leaf, index in chunks:
        assert index * chunk < numels[leaf]
        covered[leaf] += min(chunk, numels[leaf] - index * chunk)
    assert covered.tolist() == list(numels)
    assert list(chunks[:, 0]) == sorted(chunks[:, 0])


@pytest.mark.parametrize("model,leaves,values", [("G", 164, 53_018_664), ("D", 64, 50_855_682)])
def test_plan_at_the_paper_widths_is_one_group(paper_leaves, model, leaves, values):
    """Each model's leaves fit one launch pair: one grid of chunks, and no
    more gradient pointers than a launch carries."""
    numels = paper_leaves[model]
    assert (len(numels), sum(numels)) == (leaves, values)
    assert len(numels) <= fused_optim.MAX_LEAVES
    chunks = fused_optim.plan_chunks(numels)
    _check_plan(numels, chunks, fused_optim.CHUNK)
    assert len(chunks) == sum(-(-n // fused_optim.CHUNK) for n in numels)


@pytest.mark.parametrize("numels,chunk,n_chunks", [
    ([5, 0, 9, 16, 1, 0, 33], 8, 11),     # empty leaves, a leaf of exactly two chunks
    ([0, 0, 7], 4, 2),                    # empty leaves first
    ([1 << 15, (1 << 15) + 1, 1], 1 << 15, 4),  # a chunk's last value and one past it
])
def test_plan_groups_and_chunks(numels, chunk, n_chunks):
    chunks = fused_optim.plan_chunks(numels, chunk)
    _check_plan(numels, chunks, chunk)
    assert len(chunks) == n_chunks


def _meta_leaves(n, size=4):
    return [torch.zeros(size, device="meta") for _ in range(n)]


def test_more_leaves_than_a_launch_carries_are_refused():
    n = fused_optim.MAX_LEAVES + 1
    leaves = _meta_leaves(n)
    with pytest.raises(ValueError, match=f"{n} leaves, more than the"):
        fused_optim.AdamTables(leaves, leaves, leaves, [1e-3] * n, [False] * n)


def test_tables_key_holds_the_rates_and_shard_flags():
    """The kernels' tables are built anew when a leaf's learning rate or
    shard flag changes, not only when a pointer moves."""
    p, m, v = (_meta_leaves(3) for _ in range(3))
    key = fused_optim.AdamTables.key_of(p, m, v, [1e-3, 1e-3, 1e-5], [False] * 3)
    assert key == fused_optim.AdamTables.key_of(p, m, v, (1e-3, 1e-3, 1e-5), (0, 0, 0))
    assert key != fused_optim.AdamTables.key_of(p, m, v, [1e-3, 1e-3, 1e-4], [False] * 3)
    assert key != fused_optim.AdamTables.key_of(p, m, v, [1e-3, 1e-3, 1e-5],
                                                [False, True, False])


def test_tensor_level_step_is_the_optimizer_step():
    """``clipped_adam`` on CPU tensors (the optimizer's own, passed as
    tensors) returns no tables and moves every tensor as ``step`` does."""
    state = _tiny_state(0)
    opt = copy.deepcopy(state.g_opt)
    grads = _grads(opt, 5, scale=10.0)
    applied, tables = fused_optim.clipped_adam(
        opt.params, opt.exp_avg, opt.exp_avg_sq, grads, opt.count, opt.notfinite_count,
        [lr for ps, lr in opt.groups for _ in ps], [False] * len(opt.params), opt.hyper())
    assert tables is None and bool(applied)
    assert bool(state.g_opt.step(grads))
    for a, b in zip(state.g_opt.params + state.g_opt.exp_avg + state.g_opt.exp_avg_sq,
                    opt.params + opt.exp_avg + opt.exp_avg_sq):
        assert torch.equal(a, b)
    assert int(opt.count) == int(state.g_opt.count) == 1


@pytest.mark.parametrize("shape,layout,order", [
    ((128, 128, 3, 3), "contiguous", 0),
    ((128, 128, 3, 3), "channels_last", 1),
    ((128, 128, 3, 3), "io", 2),                 # as cuDNN's double backward gives it
    ((128, 6, 1, 1), "io", 2),
    ((768, 385, 3, 3), "io", 2),
    ((48, 256, 1, 1), "channels_last", 0),       # a 1x1 conv: channels-last is its order
    ((64, 32), "io", 2),                         # a column-major linear weight
    ((64, 1, 3, 3), "channels_last", 0),
    ((8, 4, 3, 5), "kio", None),                 # (K, I, O): never from cuDNN, copied
    ((8, 4, 3, 3), "hw_split", None),            # H and W apart: no [O, I, K] view
    ((1, 8, 4, 3, 3), "io", None),               # 5-d: the leaf's own order only
    ((2, 4, 4), "io", None),
])
def test_grad_order(shape, layout, order):
    """The memory order the kernels read a gradient in, from its strides."""
    t = torch.zeros(shape)
    if layout == "channels_last":
        t = t.contiguous(memory_format=torch.channels_last)
    elif layout == "io":
        t = t.transpose(0, 1).contiguous().transpose(0, 1)
    elif layout == "kio":  # [H, W, I, O] in memory: (K, I, O)
        t = t.permute(2, 3, 1, 0).contiguous().permute(3, 2, 0, 1)
    elif layout == "hw_split":  # [H, O, I, W]
        t = t.permute(2, 0, 1, 3).contiguous().permute(1, 2, 0, 3)
    assert tuple(t.shape) == shape
    assert fused_optim.grad_order(shape, t.stride()) == order


def test_grad_order_of_a_strided_view_is_none():
    t = torch.zeros(16, 32, 3, 3)[:, ::2]  # not dense
    assert fused_optim.grad_order(tuple(t.shape), t.stride()) is None


def test_plan_refuses_no_values():
    with pytest.raises(ValueError, match="no values"):
        fused_optim.plan_chunks([0, 0])


def test_constants_and_tables_match_the_cuda_source():
    src = SOURCE.read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = ([^;]+);", src))
    assert eval(consts["kChunk"]) == fused_optim.CHUNK
    assert int(consts["kMaxLeaves"]) == fused_optim.MAX_LEAVES
    assert "sizeof(AdamLeaf) == 48" in src and fused_optim.ADAM_LEAF.itemsize == 48
    assert "sizeof(EmaLeaf) == 24" in src and fused_optim.EMA_LEAF.itemsize == 24
    fields = fused_optim.ADAM_LEAF.fields
    assert [fields[k][1] for k in ("p", "m", "v", "n", "neg_lr", "sharded", "inner", "taps")
            ] == [0, 8, 16, 24, 32, 36, 40, 44]
    # the gradients' pointers and layout flags fit the 4 KB of kernel parameters
    assert fused_optim.MAX_LEAVES * 9 + 128 <= 4096


# ------------------------------------------- loaders write into the moments


def _identities(opt):
    return [id(m) for m in opt.exp_avg + opt.exp_avg_sq]


def test_from_jax_load_optimizer_copies_into_the_moments():
    state = _tiny_state()
    opt, module = state.d_opt, state.discriminator
    ids = _identities(opt)
    mu = {n: torch.full(p.shape, 0.5) for n, p in module.named_parameters()}
    nu = {n: torch.full(p.shape, 0.25) for n, p in module.named_parameters()}
    from_jax._load_optimizer(opt, module, mu, nu, 7, 2)
    assert _identities(opt) == ids
    assert all(float(m.min()) == float(m.max()) == 0.5 for m in opt.exp_avg)
    assert all(float(v.min()) == float(v.max()) == 0.25 for v in opt.exp_avg_sq)
    assert int(opt.count) == 7 and int(opt.notfinite_count) == 2


def test_install_adam_moments_copies_into_the_moments():
    state = _tiny_state()
    opt, module = state.g_opt, state.generator
    ids = _identities(opt)
    mu = {n: torch.randn(p.shape) for n, p in module.named_parameters()}
    nu = {n: torch.rand(p.shape) for n, p in module.named_parameters()}
    reference.install_adam_moments(opt, module, mu, nu, 4)
    assert _identities(opt) == ids and int(opt.count) == 4
    names = {id(p): n for n, p in module.named_parameters()}
    for p, m, v in zip(opt.params, opt.exp_avg, opt.exp_avg_sq):
        assert torch.equal(m, mu[names[id(p)]]) and torch.equal(v, nu[names[id(p)]])
    bad = dict(mu)
    bad[names[id(opt.params[0])]] = torch.zeros(3)
    with pytest.raises(ValueError, match="moment of"):
        reference.install_adam_moments(opt, module, bad, nu, 4)


def test_checkpoint_round_trip_restores_the_moments(tmp_path):
    state = _tiny_state(0)
    for seed in (3, 4):
        state.g_opt.step(_grads(state.g_opt, seed))
        state.d_opt.step(_grads(state.d_opt, seed + 10, scale=1e-3))
    manager = CheckpointManager(str(tmp_path))
    manager.save(2, train_state_dict(state))
    fresh = _tiny_state(1)
    ids = _identities(fresh.g_opt) + _identities(fresh.d_opt)
    load_train_state(fresh, copy.deepcopy(manager.load()))
    assert _identities(fresh.g_opt) + _identities(fresh.d_opt) == ids
    for src, dst in ((state.g_opt, fresh.g_opt), (state.d_opt, fresh.d_opt)):
        for key in ("exp_avg", "exp_avg_sq"):
            for a, b in zip(getattr(src, key), getattr(dst, key)):
                assert torch.equal(a, b)
        assert int(dst.count) == int(src.count) == 2
    assert all(float(m.abs().max()) > 0 for m in fresh.g_opt.exp_avg_sq)
