"""The choice of upfirdn2d's CUDA variant (``ops/upfirdn2d.py::_plan``),
checked without a GPU: every K3/K4 call site of the flagship config gets a
tiled form except the C = 3 skip upsamples, what the tiled forms do not take
gets the general form, and the codes are the ones the C source accepts."""

import itertools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from multi_stylegan_torch.models.config import (
    DiscriminatorConfig,
    GeneratorConfig,
    tiny_discriminator_config,
    tiny_generator_config,
)
from multi_stylegan_torch.models.discriminator import Discriminator
from multi_stylegan_torch.models.generator import Generator
from multi_stylegan_torch.ops import upfirdn2d as up_mod
from multi_stylegan_torch.ops.blur import blur_padding, upsample_padding

SOURCE = Path(up_mod.__file__).resolve().parent.parent / "csrc" / "upfirdn2d.cu"
ALIGNED = 1 << 40  # a 16-byte aligned device address
DTYPES = [torch.float32, torch.bfloat16]


def blur4(p):
    return (p[0], p[1], p[0], p[1])


def generator_sites(gcfg, batch):
    """(shape, up, down, normalized pad) of every upfirdn2d call of a G
    forward on a batch: the post-upsample blurs and skip upsamples per stage."""
    h0, w0 = gcfg.starting_resolution
    ch = gcfg.stage_channels
    sites = set()
    for i in range(gcfg.n_stages):
        h, w = h0 << (i + 1), w0 << (i + 1)
        sites.add(((batch, h, w, ch[i + 1]), 1, 1, blur4(blur_padding(4, 2, 2))))
        sites.add(((batch, h // 2, w // 2, gcfg.sequence_length), 2, 1,
                   blur4(upsample_padding(4, 2))))
    return sites


def forward_sites(gcfg, dcfg, batch):
    """(shape, up, down, normalized pad) of every upfirdn2d forward call of
    G and D on a batch, from the configs: G's sites, D's downscale blurs
    (after a k3 s2 p0 conv, so on odd maps) and decoder upsamples."""
    sites = generator_sites(gcfg, batch)
    h, w = gcfg.resolution
    enc, dec = dcfg.encoder_channels, dcfg.decoder_channels
    for i, (_, c) in enumerate(enc[:-1]):
        sites.add(((batch, ((h >> i) - 3) // 2 + 1, ((w >> i) - 3) // 2 + 1, c), 1, 1,
                   blur4(blur_padding(4, 2, 3))))
    n = len(enc) - 1
    for i, c in enumerate((enc[-1][1],) + tuple(d[1] for d in dec[:-1])):
        sites.add(((batch, (h >> n) << i, (w >> n) << i, c), 2, 1, blur4(upsample_padding(4, 2))))
    return sites


def launches_of(shape, up, down, pad):
    """(shape, up, down, pad) of the forward launch and of its adjoint; the
    double backward is the forward launch again."""
    b, h, w, c = shape
    ho, wo = up_mod.out_size(h, up, down, pad[0], pad[1], 4), up_mod.out_size(w, up, down, pad[2], pad[3], 4)
    gpad = up_mod._adjoint_pads((4, 4), up, down, pad, (h, w), (ho, wo))
    return [(shape, up, down, pad), ((b, ho, wo, c), down, up, gpad)]


def plan(shape, dtype, up, down, pad, k=4, ptrs=(ALIGNED, ALIGNED)):
    return up_mod.VARIANTS[up_mod._plan(shape, dtype, up, down, k, k, pad, ptrs)]


def test_site_formula_matches_the_models_calls(monkeypatch):
    """forward_sites at the tiny config is what a G and a D forward call."""
    seen = set()

    def record(x, kernel, up, down, pad, adjoint=False):
        seen.add((tuple(x.shape), up, down, tuple(pad)))
        return up_mod.upfirdn2d_ref(x, kernel, up, down, (pad[2], pad[3], pad[0], pad[1]))

    monkeypatch.setattr(up_mod, "_upfirdn", record)
    gcfg, dcfg = tiny_generator_config(), tiny_discriminator_config()
    g, d = Generator(gcfg), Discriminator(dcfg)
    g.reset_parameters(torch.Generator().manual_seed(0))
    d.reset_parameters(torch.Generator().manual_seed(1))
    rng = np.random.default_rng(2)
    with torch.no_grad():
        g(torch.from_numpy(rng.standard_normal((2, gcfg.latent_dimensions), np.float32)),
          randomize_noise=False)
        d(torch.from_numpy(rng.uniform(size=(2, 2, 3, 32, 32)).astype(np.float32)))
    assert seen == forward_sites(gcfg, dcfg, 2)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("batch", [24, 12, 6])
def test_flagship_sites_take_a_tiled_variant(batch, dtype):
    """At the flagship config every forward, adjoint and double-backward
    launch takes the tiled form of its (up, down), except at the C = 3 skip
    upsamples, which take the general one."""
    sites = forward_sites(GeneratorConfig(), DiscriminatorConfig(no_rfp=True), batch)
    assert len(sites) == 2 * 6 + 4 + 4
    for site in sites:
        for shape, up, down, pad in launches_of(*site):
            got = plan(shape, dtype, up, down, pad)
            want = "general" if shape[-1] == 3 else f"up{up}-down{down}"
            assert got == want, (shape, up, down, pad)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("batch", [15, 24, 32])
def test_sampling_sites_take_a_tiled_variant(batch, dtype):
    """The trainer samples without gradients: the sample grids at batch 15
    (15 fixed latent pairs) and validation at batch 24; the interpolation
    CLI at batch 32.  Every G forward launch there takes the tiled form,
    except the C = 3 skip upsamples."""
    sites = generator_sites(GeneratorConfig(), batch)
    assert len(sites) == 2 * 6
    for shape, up, down, pad in sites:
        want = "general" if shape[-1] == 3 else f"up{up}-down{down}"
        assert plan(shape, dtype, up, down, pad) == want, (shape, up, down, pad)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", ["input misaligned", "output misaligned", "odd C", "C=130",
                                  "k=3", "up 2 down 2", "up 4"])
def test_what_the_tiled_forms_do_not_take_goes_general(case, dtype):
    shape, up, down, pad, k, ptrs = (4, 32, 32, 256), 1, 1, (2, 1, 2, 1), 4, (ALIGNED, ALIGNED)
    itemsize = torch.tensor([], dtype=dtype).element_size()
    if case == "input misaligned":
        ptrs = (ALIGNED + itemsize, ALIGNED)
    elif case == "output misaligned":
        ptrs = (ALIGNED, ALIGNED + 8)
    elif case == "odd C":
        shape = (4, 32, 32, 7)
    elif case == "C=130":
        shape = (4, 32, 32, 130)
    elif case == "k=3":
        k = 3
    elif case == "up 2 down 2":
        up = down = 2
    else:
        up = 4
    assert plan((4, 32, 32, 256), dtype, 1, 1, pad) == "up1-down1"
    assert plan(shape, dtype, up, down, pad, k, ptrs) == "general"


def test_c_source_accepts_the_codes_plan_emits():
    """The enum and the launch switch of csrc/upfirdn2d.cu against VARIANTS,
    and every code _plan emits over a sweep of calls, in either layout, is
    one the C side launches with the call's (up, down)."""
    src = SOURCE.read_text()
    enum = dict(re.findall(r"(k\w+) = (\d+)", re.search(r"enum Variant \{([^}]*)\}", src)[1]))
    tiled = {int(enum[name]): (int(up), int(down)) for name, up, down in
             re.findall(r"case (k\w+): return launch_tiled<T, (\d), (\d),", src)}
    planar = {int(enum[name]): (int(up), 1) for name, up in
              re.findall(r"case (k\w+): if constexpr \(f32\) return launch_planar<(\d)>", src)}
    assert int(enum["kGeneral"]) == 0 and "case kGeneral: return launch_general" in src
    assert int(enum["kPlanarGeneral"]) == up_mod._PLANAR_GENERAL
    assert re.search(r"case kPlanarGeneral: \{[^}]*launch_general<T>", src)
    assert tiled == {code: pair for pair, code in up_mod._TILED.items()}
    assert planar == {code: pair for pair, code in up_mod._PLANAR_TILED.items()}
    codes = set(tiled) | set(planar) | {0, up_mod._PLANAR_GENERAL}
    assert sorted(codes) == list(range(len(up_mod.VARIANTS))) == sorted(map(int, enum.values()))
    assert [f"up{u}-down{d}" for u, d in (tiled[c] for c in sorted(tiled))] == list(up_mod.VARIANTS[1:4])
    assert up_mod.VARIANTS[up_mod._PLANAR_GENERAL] == "planar-general"
    assert all(up_mod.VARIANTS[c] == f"planar-up{u}-down{d}" for c, (u, d) in planar.items())
    vec = dict(re.findall(r"struct Vec<(\w+)> \{ static constexpr int N = (\d+); \}", src))
    assert {"float": 4, "__nv_bfloat16": 8} == {k: int(v) for k, v in vec.items()}
    assert {torch.float32: 4, torch.bfloat16: 8} == up_mod._VEC
    assert "constexpr int kTaps = 4;" in src
    emitted = set()
    for dtype, up, down, c, k, off in itertools.product(DTYPES, (1, 2, 3), (1, 2), (3, 8, 24, 130, 512),
                                                        (3, 4), (0, 2, 4)):
        code = up_mod._plan((2, 17, 23, c), dtype, up, down, k, k, (1, 2, 1, 2), (ALIGNED + off, ALIGNED))
        emitted.add(code)
        assert code == 0 or tiled[code] == (up, down)
        code = up_mod._plan((2, 17, 23, c), dtype, up, down, k, k, (1, 2, 1, 2),
                            (ALIGNED + off, ALIGNED), planar=True)
        emitted.add(code)
        assert code == up_mod._PLANAR_GENERAL or planar[code] == (up, down)
    assert emitted == codes
