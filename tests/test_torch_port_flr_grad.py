"""K2, the fused leaky-ReLU gradient (ops/fused_act.py, csrc/fused_act.cu), on
the CPU: its plain version's new forms (an f32 addend broadcast over the
rows, and dx only) against the JAX package's Pallas gradient in interpret
mode; the grad-of-grad through ``FusedLeakyReLUBackward`` against JAX's;
the CUDA kernel's launch plan at every K2 site of the flagship iteration;
and the dx-only launch formula ``chip_smoke.py`` asserts on the card."""

import collections
import itertools
import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from multi_stylegan_tpu.ops import pallas_kernels
from multi_stylegan_torch.models.config import (
    DiscriminatorConfig,
    GeneratorConfig,
    TrainingConfig,
    tiny_discriminator_config,
    tiny_generator_config,
)
from multi_stylegan_torch.models.discriminator import Discriminator
from multi_stylegan_torch.models.generator import Generator
from multi_stylegan_torch.ops import fused_act
from multi_stylegan_torch.train.draws import TorchDraws
from multi_stylegan_torch.train.state import create_train_state
from multi_stylegan_torch.train.steps import TrainStep
from test_torch_port_train import _chip_smoke

SOURCE = Path(fused_act.__file__).resolve().parent.parent / "csrc" / "fused_act.cu"
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
SMS = 132  # an H100 SXM's multiprocessors


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the suite runs several worker processes on a few
    cores, and more threads only oversubscribe them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------- plain vs the JAX kernel


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", [(40, 24), (3, 5, 7, 16)])
def test_plain_grad_with_addend_matches_the_pallas_kernel(rng, shape, dtype):
    """dx of g + gg_db (gg_db rounded to g's dtype and broadcast over the
    rows, as the double backward adds it) is the Pallas grad kernel's,
    bitwise; the bias sum of the stored dx within 1e-5."""
    g = rng.normal(size=shape).astype(np.float32)
    out = rng.normal(size=shape).astype(np.float32)
    add = rng.normal(size=shape[-1:]).astype(np.float32)
    gj, oj = jnp.asarray(g).astype(dtype), jnp.asarray(out).astype(dtype)
    summed = gj + jnp.broadcast_to(jnp.asarray(add).astype(dtype), shape)
    with pltpu.force_tpu_interpret_mode():
        ref_dx = pallas_kernels._flr_grad_from_out(summed.reshape(-1, shape[-1]),
                                                   oj.reshape(-1, shape[-1]), 0.2, math.sqrt(2.0))
    ref_dx = np.asarray(ref_dx, np.float32)
    gt, ot = _t(g).to(DTYPES[dtype]), _t(out).to(DTYPES[dtype])
    dx, db = fused_act.fused_leaky_relu_grad_ref(gt, ot, 0.2, math.sqrt(2.0), _t(add))
    np.testing.assert_array_equal(dx.float().reshape(-1, shape[-1]).numpy(), ref_dx)
    np.testing.assert_allclose(db.numpy(), ref_dx.sum(0), rtol=1e-5, atol=1e-5)
    dx_only, none = fused_act.fused_leaky_relu_grad_ref(gt, ot, 0.2, math.sqrt(2.0), _t(add),
                                                        need_db=False)
    assert none is None and torch.equal(dx_only, dx)
    # need_db alone changes nothing but the bias sum
    dx0, db0 = fused_act.fused_leaky_relu_grad_ref(gt, ot, 0.2, math.sqrt(2.0))
    assert torch.equal(fused_act.fused_leaky_relu_grad_ref(gt, ot, 0.2, math.sqrt(2.0),
                                                           need_db=False)[0], dx0)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_double_backward_matches_the_jax_vjp_of_the_pallas_gradient(rng, dtype):
    """The port's double backward (FusedLeakyReLUBackward's backward, one
    dx-only K2 with gg_db as its addend) against the VJP JAX takes of its
    own (dx, db) = (_flr_grad_from_out, f32 column sum), in interpret mode:
    dx bitwise."""
    shape = (48, 24)
    g, out, gg_dx = (rng.normal(size=shape).astype(np.float32) for _ in range(3))
    gg_db = rng.normal(size=shape[-1:]).astype(np.float32)

    def grad_pair(gj, oj):
        gi = pallas_kernels._flr_grad_from_out(gj, oj, 0.2, 1.0)
        return gi, jnp.sum(gi.astype(jnp.float32), axis=0)

    oj = jnp.asarray(out).astype(dtype)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda gj: grad_pair(gj, oj), jnp.asarray(g).astype(dtype))
        (ref,) = vjp((jnp.asarray(gg_dx).astype(dtype), jnp.asarray(gg_db)))
    gt = _t(g).to(DTYPES[dtype]).requires_grad_(True)
    dx, db = fused_act.FusedLeakyReLUBackward.apply(gt, _t(out).to(DTYPES[dtype]), 0.2, 1.0)
    (got,) = torch.autograd.grad((dx, db), gt, (_t(gg_dx).to(DTYPES[dtype]), _t(gg_db)))
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref, np.float32))


@pytest.mark.parametrize("scale", [1.0, math.sqrt(2.0)])
def test_grad_of_grad_through_the_double_backward_matches_jax(rng, scale):
    """d/d(x, b) of <grad, direction> through the Pallas op in interpret
    mode (JAX) and through the port's Functions (CPU plain versions)."""
    shape = (2, 5, 3, 8)
    x, c, dx_dir = (rng.normal(size=shape).astype(np.float32) for _ in range(3))
    b, db_dir = (rng.normal(size=(shape[-1],)).astype(np.float32) for _ in range(2))

    def loss_j(xx, bb):
        return jnp.sum(jnp.square(pallas_kernels.fused_leaky_relu_pallas(xx, bb, 0.2, scale)) * c)

    def h_j(xx, bb):
        gx, gb = jax.grad(loss_j, argnums=(0, 1))(xx, bb)
        return jnp.sum(gx * dx_dir) + jnp.sum(gb * db_dir)

    with pltpu.force_tpu_interpret_mode():
        ref = jax.grad(h_j, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(b))
    xt, bt = _t(x).requires_grad_(True), _t(b).requires_grad_(True)
    y = fused_act.fused_leaky_relu(xt, bt, 0.2, scale)
    gx, gb = torch.autograd.grad((y.square() * _t(c)).sum(), (xt, bt), create_graph=True)
    got = torch.autograd.grad((gx * _t(dx_dir)).sum() + (gb * _t(db_dir)).sum(), (xt, bt))
    for a, r in zip(got, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(a.numpy(), r, rtol=0, atol=1e-4 * max(1.0, np.abs(r).max()))


def test_third_order_goes_through_the_double_backward_function(rng):
    """The double backward is itself differentiable: its backward is K2 again
    (dx for gg_dx, the bias sum for gg_db), the linear map's transpose."""
    shape = (6, 4)
    g, out, gg_dx, c = (_t(rng.normal(size=shape).astype(np.float32)) for _ in range(4))
    gg_db = _t(rng.normal(size=shape[-1:]).astype(np.float32))
    gg_dx.requires_grad_(True)
    gg_db.requires_grad_(True)
    ggo = fused_act.FusedLeakyReLUDoubleBackward.apply(gg_dx, gg_db, out, 0.2, 1.5)
    a, b = torch.autograd.grad((ggo * c).sum(), (gg_dx, gg_db))
    mask = torch.where(out >= 0, 1.0, 0.2) * 1.5
    torch.testing.assert_close(a, c * mask)
    torch.testing.assert_close(b, (c * mask).sum(0))


# ------------------------------------------------------------- launch plan


def k1_sites(gcfg, dcfg, batch):
    """The [.., C] shape of every K1 call (and so every K2 call) of a G and
    a D forward at ``batch``: the mapping layers, the styled convs per stage,
    D's ResNet blocks (NonLocal blocks hold none: encoder 2, decoder 1), its
    scalar head and its pixel head."""
    h0, w0 = gcfg.starting_resolution
    ch = gcfg.stage_channels
    sites = {(batch, gcfg.latent_dimensions), (batch, h0, w0, ch[0])}
    for i in range(gcfg.n_stages):
        sites.add((batch, h0 << (i + 1), w0 << (i + 1), ch[i + 1]))
    h, w = gcfg.resolution
    enc, dec = dcfg.encoder_channels, dcfg.decoder_channels
    n = len(enc) - 1
    sites |= {(batch, h >> i, w >> i, c) for i, (_, c) in enumerate(enc) if i != 2}
    sites |= {(batch, (h >> n) << (i + 1), (w >> n) << (i + 1), c)
              for i, (_, c) in enumerate(dec) if i != 1}
    sites |= {(batch, 128), (batch, h, w, dec[-1][1])}
    return sites


def test_site_formula_matches_the_models_calls(monkeypatch):
    seen = set()

    def record(x, bias, negative_slope, scale):
        seen.add(tuple(x.shape))
        return fused_act.fused_leaky_relu_ref(x, bias, negative_slope, scale)

    monkeypatch.setattr(fused_act, "_forward", record)
    gcfg, dcfg = tiny_generator_config(), tiny_discriminator_config()
    g, d = Generator(gcfg), Discriminator(dcfg)
    g.reset_parameters(torch.Generator().manual_seed(0))
    d.reset_parameters(torch.Generator().manual_seed(1))
    rng = np.random.default_rng(2)
    with torch.no_grad():
        g(torch.from_numpy(rng.standard_normal((2, gcfg.latent_dimensions), np.float32)),
          randomize_noise=False)
        d(torch.from_numpy(rng.uniform(size=(2, 2, 3, 32, 32)).astype(np.float32)))
    assert seen == k1_sites(gcfg, dcfg, 2)


def _check_plan(plan, m, c, dtype, need_db):
    vec = fused_act._VEC[dtype] if plan.vector else 1
    # a warp across a row, or a power of two narrower where a row is narrower
    assert plan.lanes == 32 or plan.lanes >= -(-c // vec) > plan.lanes // 2
    assert 32 % plan.lanes == 0
    gx, gy = plan.grid
    assert gy == -(-c // (plan.lanes * vec))
    # one persistent wave: about _BLOCKS_PER_SM blocks a SM, never more
    assert 1 <= gx and gx * gy < fused_act._BLOCKS_PER_SM * SMS + gy
    # contiguous row runs that cover the rows once, none of them empty
    assert gx * plan.rows_per_block >= m > (gx - 1) * plan.rows_per_block
    if gx > 1:  # no more blocks than the rows need: an unrolled step a thread
        assert plan.rows_per_block >= fused_act._UNROLL * fused_act._THREADS // plan.lanes
    assert plan.partial_rows == (gx if need_db and gx > 1 else 0)
    assert plan.scratch_floats == plan.partial_rows * c


@pytest.mark.parametrize("need_db", [True, False])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("batch", [24, 12, 6])
def test_flagship_sites_take_the_vector_form_in_one_wave(batch, dtype, need_db):
    """Every K2 site of the flagship iteration (G at 24 and 12, D at 24 and
    the wrong-order 6) takes the 16-byte vector form with a grid of one
    wave, and its bias sum needs at most a few hundred partial rows."""
    dt = DTYPES[dtype]
    sites = k1_sites(GeneratorConfig(), DiscriminatorConfig(no_rfp=True), batch)
    assert len(sites) == 8 + 5  # G: the mapping, 7 resolutions; D: 4 maps, the head
    for shape in sites:
        c, m = shape[-1], math.prod(shape[:-1])
        plan = fused_act._grad_plan(m, c, dt, True, SMS, need_db)
        assert plan.vector, shape
        # C = 128 in bf16 is 16 vectors: a warp spans two rows
        assert plan.lanes == min(32, c // fused_act._VEC[dt]), shape
        _check_plan(plan, m, c, dt, need_db)
        assert plan.scratch_floats * 4 <= 2 << 20, shape


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", ["C=130", "misaligned", "mapping [24, 512]", "M*C > 2^31",
                                  "one row", "C=4096"])
def test_plan_edges(case, dtype):
    dt = DTYPES[dtype]
    m, c, aligned = {"C=130": (1000, 130, True), "misaligned": (3 * 81, 256, False),
                     "mapping [24, 512]": (24, 512, True),
                     "M*C > 2^31": (64 * 256 * 256 + 1, 512, True),
                     "one row": (1, 768, True), "C=4096": (4096, 4096, True)}[case]
    plan = fused_act._grad_plan(m, c, dt, aligned, SMS, True)
    _check_plan(plan, m, c, dt, True)
    assert plan.vector == (case not in ("C=130", "misaligned"))
    if case in ("mapping [24, 512]", "one row"):
        # one row block: it writes the bias sum itself, no scratch, no ticket
        assert plan.grid[0] == 1 and plan.partial_rows == 0
    if case == "M*C > 2^31":
        assert m * c > 2**31 and plan.rows_per_block * c > 2**31 // (3 * SMS)
    if case == "C=130":
        assert plan.grid[1] == 5  # 32-column slices, the last one ragged


def test_c_source_matches_the_plan_constants():
    src = SOURCE.read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(consts["kThreads"]) == fused_act._THREADS
    assert int(consts["kLanes"]) == fused_act._LANES
    assert int(consts["kUnroll"]) == fused_act._UNROLL
    assert int(consts["kBlocksPerSm"]) == fused_act._BLOCKS_PER_SM
    assert "__launch_bounds__(kThreads, kBlocksPerSm)" in src
    vec = dict(re.findall(r"struct Vec<(\w+)> \{ static constexpr int N = (\d+); \}", src))
    assert {torch.float32: int(vec["float"]), torch.bfloat16: int(vec["__nv_bfloat16"])} \
        == fused_act._VEC
    entry = re.search(r'extern "C" int flr_grad\(([^)]*)\)', src)[1]
    assert len(entry.split(",")) == 17 == len(fused_act._ARGTYPES)
    assert re.search(r"case (\d): return launch<float>", src)[1] == str(
        fused_act._DTYPE_CODES[torch.float32])
    assert re.search(r"case (\d): return launch<__nv_bfloat16>", src)[1] == str(
        fused_act._DTYPE_CODES[torch.bfloat16])


def test_plans_sweep_cover_both_forms_and_one_and_many_row_blocks():
    kinds = set()
    for dtype, m, c, aligned, need_db in itertools.product(
            DTYPES.values(), (1, 31, 32, 33, 1000, 10**6), (1, 8, 130, 512, 1024),
            (True, False), (True, False)):
        plan = fused_act._grad_plan(m, c, dtype, aligned, SMS, need_db)
        _check_plan(plan, m, c, dtype, need_db)
        kinds.add((plan.vector, plan.grid[0] > 1, plan.partial_rows > 0))
    assert kinds == {(v, many, many and db) for v in (True, False) for many in (True, False)
                     for db in (True, False)}


# ------------------------------------------------------ dx-only launch formula


@pytest.mark.parametrize("remat", [True, False])
def test_dx_only_formula_matches_counted_dispatches(remat, monkeypatch):
    """chip_smoke.py asserts each sub-step's dx-only K2 launches on the card
    from ``expected_dx_only``; on the CPU the same dispatches reach the
    plain version, counted here at the tiny config, with the total K2
    launches still ``expected_launches``'."""
    from test_torch_port_train import B, _real

    counts = collections.Counter()
    grad = fused_act._grad

    def count(g, out, slope, scale, addend=None, need_db=True):
        counts["K2"] += 1
        counts["dx only"] += not need_db
        counts["addend"] += addend is not None
        return grad(g, out, slope, scale, addend, need_db)

    monkeypatch.setattr(fused_act, "_grad", count)
    gcfg, dcfg = tiny_generator_config(remat=remat), tiny_discriminator_config(remat=remat)
    g, d = Generator(gcfg), Discriminator(dcfg)
    g.reset_parameters(torch.Generator().manual_seed(0))
    d.reset_parameters(torch.Generator().manual_seed(1))
    cfg = TrainingConfig(batch_size=B)
    state, ts = create_train_state(g, d, cfg), TrainStep(cfg)
    draws = TorchDraws(torch.Generator().manual_seed(2))
    real = _t(_real())
    smoke = _chip_smoke()
    runs = [("d_step", lambda: ts.d_step(state, real, True, draws)),
            ("g_step", lambda: ts.g_step(state, B, draws)),
            ("r1_update", lambda: ts.r1_update(state, real)),
            ("path_length_update", lambda: ts.path_length_update(state, draws))]
    for name, run in runs:
        counts.clear()
        run()
        want = smoke.expected_dx_only(gcfg, dcfg, name)
        assert counts["dx only"] == counts["addend"] == want, name
        assert counts["K2"] == smoke.expected_launches(gcfg, dcfg, name,
                                                       wrong_order=(name == "d_step"))["K2"]
    assert smoke.expected_dx_only(gcfg, dcfg, "r1_update") > 0
