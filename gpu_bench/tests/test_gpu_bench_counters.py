"""The FLOP counter against torch's own, and the kernels' byte and
operation bounds against chip_smoke.py's."""

import importlib.util

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from gpu_bench import bench, flops, kernels
from gpu_bench.tests.tiny import TINY


class GlobalOnly:
    parents = {"Global"}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def tiny_config(dtype):
    cfg = bench.load_json(bench.BENCH / "configs" / "msg256-bf16.json")
    for key in ("generator", "discriminator"):
        cfg[key] = {**cfg[key], **TINY[key], "remat": False, "compute_dtype": dtype}
    cfg["training"] = {**cfg["training"], "compute_dtype": dtype}
    return cfg


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flops_match_torch(dtype, monkeypatch):
    counted = {}

    def total(fn):
        ref = FlopCounterMode(display=False)
        # torch's module tracker hooks refuse autograd.grad (R1, path length):
        # count every op under its global entry alone
        ref.mod_tracker = GlobalOnly()
        with ref:
            out = fn()
        counted.setdefault("torch", []).append(ref.get_total_flops())
        return out

    real = flops.count
    monkeypatch.setattr(flops, "count", lambda fn: (real(fn), total(fn))[0])
    parts = flops.training(tiny_config(dtype), 4)
    assert [sum(p.values()) for p in parts.values()] == counted["torch"]
    assert all(n > 0 for p in parts.values() for n in p.values())
    if dtype == "bfloat16":  # the main step's convolutions run in bf16
        assert parts["main"]["torch.bfloat16"] > parts["main"].get("torch.float32", 0)
    counted.clear()
    sample = flops.sampling(tiny_config(dtype), 2)
    assert sum(sample.values()) == counted["torch"][0]


def test_least_seconds():
    assert flops.least_seconds({"torch.bfloat16": 989e12, "torch.float32": 495e12}) == 2.0


def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", bench.ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("key", [
    ("K1", (16, 256, 256, 512), "torch.float32"),
    ("K1", (24, 512), "torch.bfloat16"),
    ("K2", (24, 64, 64, 512), "torch.bfloat16"),
    ("K3", (16, 128, 128, 512), "torch.float32", 1, 1, (2, 1, 2, 1), (4, 4)),
    ("K3", (16, 64, 64, 3), "torch.float32", 2, 1, (2, 1, 2, 1), (4, 4)),
    ("K4", (24, 128, 128, 256), "torch.bfloat16", 1, 2, (1, 1, 1, 1), (4, 4)),
])
def test_bounds_match_chip_smoke(key):
    cs = smoke()
    kind, shape, dtype = key[:3]
    size = kernels.ITEMSIZE[dtype]
    if kind in ("K1", "K2"):
        c, m = shape[-1], int(torch.tensor(shape[:-1]).prod())
        nbytes = (2 if kind == "K1" else 3) * m * c * size + c * 4
        want = cs.bound_ms(nbytes, 4 * m * c)[0]
    else:
        up, down, pad, (kh, kw) = key[3:]
        b, h, w, c = shape
        ho = kernels.out_size(h, up, down, pad[0], pad[1], kh)
        wo = kernels.out_size(w, up, down, pad[2], pad[3], kw)
        used = (cs.upfirdn_taps_used(h, ho, up, down, pad[0], kh)
                * cs.upfirdn_taps_used(w, wo, up, down, pad[2], kw))
        want = cs.bound_ms((b * h * w * c + b * ho * wo * c) * size + kh * kw * 4,
                           2 * used * b * c)[0]
    assert kernels.launch_bound_s(key) * 1e3 == pytest.approx(want, rel=1e-12)


def test_census_counts_each_site():
    from multi_stylegan_torch.ops import fused_act, upfirdn2d

    x = torch.randn(2, 8, 8, 4, requires_grad=True)
    with kernels.Census() as census:
        y = fused_act.fused_leaky_relu(x, torch.zeros(4))
        z = upfirdn2d.upfirdn2d(y, torch.ones(4, 4) / 16, 2, 1, (2, 1))
        z.sum().backward()
    assert census.launches() == {"K1": 1, "K2": 1, "K3": 1, "K4": 1}
    assert kernels.bound_by_op(census.sites)["upfirdn2d"] > 0
