"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA card and skips without one.

This file imports no JAX, so it also runs where only PyTorch is
installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerances: a kernel's outputs within 1e-5·max(1, |ref|max) of the plain
version (the same f32 algebra; nvcc may contract a*b+c into an FMA); a
multi-step run within 2e-5·max(1, |ref|max) on every state leaf.
"""

import numpy as np
import pytest
import torch

from fluid2d_tpu_torch import SimConfig, get_scene, init_state, make_run_fn
from fluid2d_tpu_torch.ops import cuda_phases, cuda_stencil

torch.set_num_threads(1)

RES = 64  # scene 2 on a (128, 64) grid: whole 32×8 thread blocks
RAGGED_RES = 37  # (74, 37): neither axis a multiple of the block


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU build")
    return torch.device("cuda", 0)


def _assert_close(got, ref, what, tol):
    assert len(got) == len(ref)
    for k, (g, r) in enumerate(zip(got, ref)):
        assert g.shape == r.shape and g.dtype == r.dtype, f"{what}[{k}]"
        scale = max(1.0, float(r.abs().max()))
        err = float((g - r).abs().max())
        assert err <= tol * scale, f"{what}[{k}]: max error {err} > {tol} * {scale}"


def _kernel_calls(res: int, device):
    """(wrapper, plain version, args, kwargs) per kernel on seeded inputs."""
    cfg = SimConfig.create(resolution=res, re=1000.0)
    sc = get_scene(2, res, device)
    shape = sc.shape
    gen = torch.Generator(device="cpu").manual_seed(res)

    def rnd(lead, scale):
        return (scale * torch.randn((*lead, *shape), generator=gen)).to(device)

    p, pa = rnd((), 0.3), rnd((), 0.3)
    u, w = rnd((), 8.0), rnd((), 8.0)
    v, va = rnd((2,), 0.5), rnd((2,), 0.5)
    vg = [rnd((2,), 0.1) for _ in range(4)]
    dye = rnd((3,), 0.5) + 0.5
    dg = [rnd((3,), 0.1) for _ in range(5)]
    sor = (p, pa, u, w, sc.pbc_code, sc.fluid8, cfg.sor_omega, cfg.dt, cfg.dx)
    return [
        (cuda_stencil.sor_iteration_cuda, cuda_stencil.sor_iteration_plain, sor, {}),
        (cuda_stencil.sor_iteration_cuda, cuda_stencil.sor_iteration_plain, sor,
         {"v_limit": cfg.velocity_limit}),
        (cuda_phases.confinement_cuda, cuda_phases.confinement_plain,
         (v, va, sc.fluid8, cfg.dt, 5.0, cfg.dx), {}),
        (cuda_phases.cip_velocity_phase_cuda, cuda_phases.cip_velocity_phase_plain,
         (v, p, va, vg[0], vg[1], vg[2], vg[3], sc, cfg.re, cfg.dt, cfg.dx), {}),
        (cuda_phases.cip_dye_phase_cuda, cuda_phases.cip_dye_phase_plain,
         (dye, *dg, v, sc, cfg.re, cfg.dt, cfg.dx), {}),
    ]


@pytest.mark.cuda
@pytest.mark.parametrize("res", [RES, RAGGED_RES])
@pytest.mark.parametrize("which", range(5),
                         ids=["sor", "sor_v_limit", "confinement", "cip_velocity", "cip_dye"])
def test_cuda_kernel_matches_plain(cuda_device, which, res):
    wrapper, plain, args, kwargs = _kernel_calls(res, cuda_device)[which]
    before = wrapper.launches
    got = wrapper(*args, **kwargs)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    _assert_close(got, plain(*args, **kwargs), wrapper.__name__, 1e-5)


@pytest.mark.cuda
def test_cuda_wrapper_refuses_wrong_operands(cuda_device):
    wrapper, _, args, kwargs = _kernel_calls(RES, cuda_device)[2]  # confinement
    v, va, fluid8, *rest = args
    with pytest.raises(TypeError, match="dtype"):
        wrapper(v, va.double(), fluid8, *rest, **kwargs)
    with pytest.raises(ValueError, match="contiguous"):
        wrapper(v, va.transpose(1, 2).contiguous().transpose(1, 2), fluid8, *rest, **kwargs)
    with pytest.raises(ValueError, match="on cpu"):
        wrapper(v, va.cpu(), fluid8, *rest, **kwargs)


@pytest.mark.cuda
def test_cuda_run_matches_eager_run(cuda_device):
    """4 steps through the kernels against 4 through the plain versions,
    from a seeded smooth state, every leaf within 2e-5·max(1, |ref|max)."""
    res = RES
    sc = get_scene(2, res, cuda_device)
    x_rows, y_cols = sc.shape
    fluid = (sc.mask == 0).float()
    gx = torch.linspace(0, 2 * np.pi, x_rows, device=cuda_device)[:, None]
    gy = torch.linspace(0, 2 * np.pi, y_cols, device=cuda_device)[None, :]
    outs = {}
    for mode in ("cuda", "eager"):
        cfg = SimConfig.create(resolution=res, kernels=mode)
        st = init_state(sc, cfg, cuda_device)
        st = st._replace(
            v=torch.stack([0.3 * torch.sin(gx) * torch.cos(2 * gy) * fluid,
                           0.2 * torch.cos(2 * gx) * torch.sin(gy) * fluid]),
            p=0.1 * torch.sin(gx + gy) * fluid,
            dye=torch.stack([0.5 + 0.4 * torch.sin(k * gx) * torch.cos(gy) * fluid
                             for k in (1, 2, 3)]),
        )
        outs[mode] = make_run_fn(cfg)(st, sc, 4)
    got = [leaf for leaf in outs["cuda"] if leaf is not None]
    ref = [leaf for leaf in outs["eager"] if leaf is not None]
    _assert_close([g.float() for g in got], [r.float() for r in ref], "state", 2e-5)
