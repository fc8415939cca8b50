"""Performance measurement: step timing, roofline accounting, traces (port of
``fluid2d_tpu/utils/profiling.py``).

The roofline is measured on the device it describes, as in the JAX
package: the achievable copy bandwidth (probe C2), each kernel's operand-mix
ceiling (probe C3, a no-op twin of the kernel's operands) and the FMA rate
(probe C4) are timed on the card, and each kernel's bytes and weighted
element-ops per step are counted from one step of the model. What differs
from the JAX package:

* the byte ledger is ``ops/launch.py:TRAFFIC_LOG``, which the phase
  wrappers append to (the counterpart of ``pallas_stencil.TRAFFIC_LOG``);
  its bytes are each operand of a kernel's C entry point once, where the
  TPU ledger counted BlockSpec fetches with their re-fetched halo rows;
* one twin per kernel variant (the port has one fetch geometry), and the
  twin's registry describes the port's kernels, not the Pallas BlockSpecs;
* element-ops are counted from the aten ops of each kernel's plain PyTorch
  version (:func:`collect_elops`), not from the Pallas kernel bodies, so
  the counts differ from the JAX package's;
* every probe takes an explicit ``device``; on a CPU device the copy and
  twin probes time their plain versions (approximate, cache-sized figures)
  and the FMA probe returns ``None``;
* at bf16 transport each ceiling is the bf16 twin's (the kernel's state
  planes bf16, the float32 planes it keeps float32); the JAX package's
  extra "bf16 at 2× tile" arm has no counterpart, the port's kernels having
  no tile.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from fluid2d_tpu_torch.config import SimConfig
from fluid2d_tpu_torch.models.simulator import make_run_fn, make_step_fn, scene_for_dtype
from fluid2d_tpu_torch.ops import launch as _launch
from fluid2d_tpu_torch.ops.cuda_probes import (
    FMA_CHAINS,
    MixOperands,
    copy_add1_cuda,
    fma_rate_cuda,
    mix_twin_cuda,
)
from fluid2d_tpu_torch.scenes.compile import Scene, get_scene
from fluid2d_tpu_torch.state import SimState, init_state

__all__ = [
    "sync",
    "time_steps",
    "seconds_per_call",
    "measure_hbm_bandwidth",
    "mix_bytes",
    "twin_operands",
    "measure_mix_ceiling",
    "collect_elops",
    "measure_fma_throughput",
    "step_min_bytes",
    "step_kernel_bytes",
    "step_kernel_elops",
    "roofline_report",
    "device_name",
    "trace",
]


def sync(state: SimState) -> None:
    """Fence execution: synchronize the card, then read one value to the
    host."""
    if state.v.device.type == "cuda":
        torch.cuda.synchronize(state.v.device)
    float(state.v.reshape(-1)[0])


def time_steps(run, state: SimState, scene: Scene, n: int) -> tuple[float, SimState]:
    """Seconds per step of `run(state, scene, n)`, timed on a second call
    after a warm-up call with the same n. Returns the state after both."""
    state = run(state, scene, n)
    sync(state)
    t0 = time.perf_counter()
    state = run(state, scene, n)
    sync(state)
    return (time.perf_counter() - t0) / n, state


def seconds_per_call(fn, iters: int, device: torch.device) -> float:
    """Mean seconds per call of `fn` over `iters` calls after two warm-up
    calls: CUDA events around the loop on a card, the host clock on the
    CPU."""
    fn()
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters
    with torch.cuda.device(device):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / iters


def measure_hbm_bandwidth(mbytes: int = 320, iters: int = 2000,
                          device: torch.device | str = "cuda") -> float:
    """Achievable streaming bandwidth (bytes/s, one read and one write per
    element) on `device`: the copy kernel ``o = x + 1`` (probe C2) over a
    (X, 2048) float32 array, ping-ponged between two buffers so that no
    launch reads what the previous one left in the cache.

    The working set (`mbytes` in and out together) must exceed the card's
    50 MB L2, as the TPU probe's had to exceed VMEM; at the default 320 MB
    each buffer is 160 MB. On a CPU device the plain version is timed
    (with a small buffer this is a cache figure, not a memory one)."""
    dev = torch.device(device)
    y = 2048
    x = max(64, (mbytes * 2**20 // 2 // 4 // y) // 64 * 64)
    bufs = [torch.ones((x, y), dtype=torch.float32, device=dev),
            torch.empty((x, y), dtype=torch.float32, device=dev)]
    iters = min(iters, max(200, int(6e11 / (2 * x * y * 4))))
    flip = [0]

    def once():
        k = flip[0]
        copy_add1_cuda(bufs[k], out=bufs[1 - k])
        flip[0] = 1 - k

    return 2 * x * y * 4 / seconds_per_call(once, iters, dev)


# --- per-kernel mix ceilings ------------------------------------------------------
#
# Each kernel variant's operands as its C entry point takes them: the
# number of (X, Y) planes of each input and output, in argument order
# (scratch excluded), by storage: "f_in" / "f_out" are stored in the
# transport dtype (float32 or bfloat16), "w_in" / "w_out" in float32 at
# either transport dtype (the float32 pressure pair between the calls of a
# chain, ops/cuda_stencil.py), "i8_in" as int8. The ledger names are the
# ones the phase wrappers log (ops/cuda_phases.py, ops/cuda_stencil.py);
# mix_bytes must equal the logged bytes (tests/test_torch_profiling.py).


def _pressure_mixes(name: str) -> dict[str, dict]:
    """The pressure call's links: the pair read and the pair returned each
    in the transport dtype or (``_f32in`` / ``_f32out``) in float32; u, w
    and the codes; the limited velocity with ``_v_limit``."""
    mixes = {}
    for wide_in in (False, True):
        for wide_out in (False, True):
            link = name + ("_f32in" if wide_in else "") + ("_f32out" if wide_out else "")
            mix = {"f_in": (1, 1) if wide_in else (1, 1, 1, 1),  # [p, p_alt,] u, w
                   "w_in": (1, 1) if wide_in else (),  # [p, p_alt]
                   "i8_in": (1, 1),  # code, mask
                   "f_out": () if wide_out else (1, 1),
                   "w_out": (1, 1) if wide_out else ()}
            mixes[link] = mix
            mixes[link + "_v_limit"] = {**mix, "f_out": (*mix["f_out"], 2)}
    return mixes


_KERNEL_MIXES: dict[str, dict] = {
    # v, p, v_alt, vx, vx_alt, vy, vy_alt, bc_const; vbc_code, not_wall8, fluid8
    "cip_velocity_phase": {"f_in": (2, 1, 2, 2, 2, 2, 2, 2), "i8_in": (1, 1, 1),
                           "f_out": (2,) * 6},
    # dye, dye_alt, dyex, dyex_alt, dyey, dyey_alt, vel, bc_dye; inflow8, not_wall8, fluid8
    "cip_dye_phase": {"f_in": (3, 3, 3, 3, 3, 3, 2, 3), "i8_in": (1, 1, 1),
                      "f_out": (3,) * 6},
    # v, v_alt; fluid8
    "confinement": {"f_in": (2, 2), "i8_in": (1,), "f_out": (2,)},
    **_pressure_mixes("sor_iteration"),
    **{k: v for n in range(1, 5) for k, v in _pressure_mixes(f"jacobi_iteration_n{n}").items()},
    # v, p, v_alt, bc_const; vbc_code, fluid8
    **{f"mac_velocity_phase_{s}": {"f_in": (2, 1, 2, 2), "i8_in": (1, 1), "f_out": (2, 2)}
       for s in ("upwind", "kk")},
    # dye, dye_alt, vel, bc_dye; inflow8, fluid8
    **{f"mac_dye_phase_{s}": {"f_in": (3, 3, 2, 3), "i8_in": (1, 1), "f_out": (3, 3)}
       for s in ("upwind", "kk")},
    # the standalone CIP advection (C1): f, fx, fy, vel, alt_f, alt_fx, alt_fy;
    # fluid8 — the dye form, and the velocity advecting itself (vel is f)
    "cip_advect": {"f_in": (3, 3, 3, 2, 3, 3, 3), "i8_in": (1,), "f_out": (3, 3, 3)},
    "cip_advect_self": {"f_in": (2,) * 6, "i8_in": (1,), "f_out": (2, 2, 2)},
}


def _planes(mix: dict, key: str) -> int:
    return sum(mix.get(key, ()))


def mix_bytes(name: str, x_rows: int, y_cols: int, itemsize: int = 4) -> int | None:
    """Bytes per call of kernel variant `name` by its registered operand
    mix, its transport-dtype planes `itemsize` bytes an element (4 float32,
    2 bfloat16), its float32 planes 4 and its int8 planes 1: each operand
    read or written once. None when unregistered."""
    mix = _KERNEL_MIXES.get(name)
    if mix is None:
        return None
    planes = (itemsize * (_planes(mix, "f_in") + _planes(mix, "f_out"))
              + 4 * (_planes(mix, "w_in") + _planes(mix, "w_out")) + _planes(mix, "i8_in"))
    return planes * x_rows * y_cols


def twin_operands(name: str, x_rows: int, y_cols: int, device: torch.device | str,
                  dtype: torch.dtype | str = torch.float32) -> MixOperands:
    """Distinct seeded planes for kernel variant `name`'s twin at transport
    `dtype`: random normal float planes (the transport-dtype ones in
    `dtype`, the others float32) and int8 planes in [-3, 3]."""
    mix = _KERNEL_MIXES[name]
    dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    shape = (x_rows, y_cols)

    def planes(n, dtype=torch.float32):
        return [torch.randn(shape, generator=gen, device=dev).to(dtype) for _ in range(n)]

    f_in, w_in = planes(_planes(mix, "f_in"), dt), planes(_planes(mix, "w_in"))
    i8_in = [torch.randint(-3, 4, shape, generator=gen, device=dev, dtype=torch.int8)
             for _ in range(_planes(mix, "i8_in"))]
    n_f_out, n_w_out = _planes(mix, "f_out"), _planes(mix, "w_out")
    if dt == torch.float32:
        return MixOperands(f_in + w_in, i8_in, n_f_out + n_w_out)
    return MixOperands(w_in, i8_in, n_w_out, bf16_in=f_in, n_out16=n_f_out)


def measure_mix_ceiling(name: str, x_rows: int, y_cols: int, iters: int | None = None,
                        device: torch.device | str = "cuda",
                        dtype: torch.dtype | str = torch.float32) -> tuple[float, int] | None:
    """Measured ceiling (bytes/s, and bytes per call) of kernel variant
    `name`'s operand mix at the (x_rows, y_cols) grid and transport
    `dtype`: the no-op twin (probe C3; at bf16 the probe C5c) on distinct
    planes, which reads every input once and writes every output once.
    None when `name` has no registered mix."""
    if name not in _KERNEL_MIXES:
        return None
    dev = torch.device(device)
    dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    ops = twin_operands(name, x_rows, y_cols, dev, dt)
    nbytes = mix_bytes(name, x_rows, y_cols, dt.itemsize)
    if iters is None:
        iters = min(2000, max(100, int(3e11 / nbytes)))
    return nbytes / seconds_per_call(lambda: mix_twin_cuda(ops), iters, dev), nbytes


# --- element-op counts --------------------------------------------------------------
#
# Weighted element-ops of each aten op a plain version runs: the output's
# element count times a weight (division and the transcendental or
# power-like ops weigh 3, sign 2, the rest 1); reductions count their input;
# views, copies, indexing, concatenation and tensor creation are free. The
# JAX package walks the Pallas kernel bodies instead (profiling.py:614-696),
# whose windows factor constants out of the sums and whose shifts are
# in-register, so the two counts differ; each is only compared within its
# own package.

_FREE = frozenset({
    "view", "_unsafe_view", "reshape", "expand", "slice", "select", "squeeze", "unsqueeze",
    "permute", "t", "transpose", "as_strided", "alias", "detach", "clone", "copy", "_to_copy",
    "contiguous", "lift_fresh", "lift_fresh_copy", "cat", "stack", "index", "index_select",
    "gather", "split", "unbind", "narrow", "empty", "empty_like", "empty_strided", "zeros",
    "zeros_like", "ones", "ones_like", "full", "full_like", "new_empty", "new_empty_strided",
    "new_zeros", "new_ones", "new_full", "scalar_tensor", "arange", "_local_scalar_dense",
})
_HEAVY = {"div": 3.0, "sqrt": 3.0, "rsqrt": 3.0, "exp": 3.0, "log": 3.0, "tanh": 3.0,
          "sigmoid": 3.0, "pow": 3.0, "remainder": 3.0, "fmod": 3.0, "reciprocal": 3.0,
          "sign": 2.0}
_REDUCE = frozenset({"sum", "mean", "amax", "amin", "max", "min", "prod", "any", "all",
                     "argmax", "argmin", "norm", "linalg_vector_norm"})


def _first_tensor(xs):
    for x in xs if isinstance(xs, (tuple, list)) else (xs,):
        if isinstance(x, torch.Tensor):
            return x
    return None


def _op_elops(func, args, out) -> float:
    name = func.overloadpacket.__name__
    if name.endswith("_") and not name.startswith("_"):
        name = name[:-1]  # in place: add_ counts as add
    if name in _FREE:
        return 0.0
    t = _first_tensor(args) if name in _REDUCE else _first_tensor(out)
    if t is None:
        return 0.0
    return float(t.numel()) * _HEAVY.get(name, 1.0)


class _ElopCounter(TorchDispatchMode):
    """Counts the weighted element-ops of every aten op, in total and per
    kernel: an op counts toward the last ledger entry before it, that is
    the wrapper whose plain version runs it (in a model step, the only op
    outside a wrapper, the step counter's one-element add, counts toward
    the wrapper before it)."""

    def __init__(self, ledger: list[tuple[str, int]]):
        super().__init__()
        self.ledger = ledger
        self.total = 0.0
        self.per_kernel: dict[str, float] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        n = _op_elops(func, args, out)
        if n:
            self.total += n
            if self.ledger:
                name = self.ledger[-1][0]
                self.per_kernel[name] = self.per_kernel.get(name, 0.0) + n
        return out


def collect_elops(fn, *args, **kwargs) -> tuple[float, dict[str, float]]:
    """Run ``fn(*args, **kwargs)`` and count the weighted element-ops of
    the aten ops it runs: ``(total, per kernel)``, the per-kernel counts
    keyed by the byte ledger's names (empty when `fn` enters no phase
    wrapper). Wrappers count only on tensors that take the plain version
    (CPU tensors, or fake ones: :func:`step_kernel_elops`)."""
    ledger: list[tuple[str, int]] = []
    prev, _launch.TRAFFIC_LOG = _launch.TRAFFIC_LOG, ledger
    counter = _ElopCounter(ledger)
    try:
        with counter:
            fn(*args, **kwargs)
    finally:
        _launch.TRAFFIC_LOG = prev
    return counter.total, counter.per_kernel


def measure_fma_throughput(passes: int = 8192, iters: int = 20,
                           device: torch.device | str = "cuda") -> float | None:
    """Best achievable FP32 FMA rate (weighted element-ops/s) on `device`:
    the probe C4 kernel, FMA_CHAINS independent chains per element of a
    (2048, 1024) float32 array, `passes` FMA element-passes per element.
    One FMA counts as 2 weighted el-ops, as a multiply and an add count in
    :func:`collect_elops`. None on a CPU device."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    rows, cols = 2048, 1024
    x = torch.full((rows, cols), 0.5, dtype=torch.float32, device=dev)
    sec = seconds_per_call(lambda: fma_rate_cuda(x, passes), iters, dev)
    # Per element: passes FMAs at weight 2, FMA_CHAINS start multiplies and
    # FMA_CHAINS - 1 merge adds at weight 1.
    return rows * cols * (2 * passes + 2 * FMA_CHAINS - 1) / sec


def step_min_bytes(cfg: SimConfig, x_rows: int, y_cols: int) -> int:
    """Lower bound on device-memory bytes one step must move: every carried
    array written once + each phase's inputs read once (the JAX package's
    count, unchanged)."""
    cell = x_rows * y_cols * torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
    if cfg.scheme == "cip":
        writes = 2 * 6  # v/vx/vy cur+na
        reads = 2 * 7 + 1  # v, p, v_alt, grads+alts, masks-ish
    else:
        writes = 2 * 2
        reads = 2 * 3 + 1
    if cfg.vor_eps is not None:
        writes += 2
        reads += 2
    # pressure: per iteration read p, p_alt, u, w; write pn, pc
    writes += 2 * cfg.n_pressure_iter
    reads += 4 * cfg.n_pressure_iter
    writes += 2  # limiter
    reads += 2
    if cfg.enable_dye:
        chans = 3
        if cfg.scheme == "cip":
            writes += chans * 6
            reads += chans * 6 + 2
        else:
            writes += chans * 2
            reads += chans * 2 + 2
    return (writes + reads) * cell


def _sum_by_name(ledger: list[tuple[str, int]]) -> dict[str, int]:
    per: dict[str, int] = {}
    for name, nbytes in ledger:
        per[name] = per.get(name, 0) + nbytes
    return per


def step_kernel_bytes(cfg: SimConfig, res: int, bc: int = 2,
                      device: torch.device | str = "cpu") -> dict[str, int]:
    """Per-kernel bytes of one step of `cfg` on scene `bc` at `res`, from
    the byte ledger of one step run on `device` (the counterpart of
    ``step_blockspec_bytes``). ``{}`` for ``kernels="eager"``, which never
    enters a wrapper."""
    dev = torch.device(device)
    scene = scene_for_dtype(get_scene(bc, res, dev), cfg)
    state = init_state(scene, cfg, dev)
    ledger: list[tuple[str, int]] = []
    prev, _launch.TRAFFIC_LOG = _launch.TRAFFIC_LOG, ledger
    try:
        make_step_fn(cfg)(state, scene)
    finally:
        _launch.TRAFFIC_LOG = prev
    return _sum_by_name(ledger)


def step_kernel_elops(cfg: SimConfig, res: int, bc: int = 2) -> dict[str, float]:
    """Per-kernel weighted element-ops of one step of `cfg` on scene `bc`
    at `res`: the kernels' plain versions run on fake CPU tensors (shapes
    without data, so nothing is computed), counted by
    :func:`collect_elops`. Keys match :func:`step_kernel_bytes`."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    scene = scene_for_dtype(get_scene(bc, res, "cpu"), cfg)
    fake = FakeTensorMode()
    fake_scene = Scene(*(fake.from_tensor(t) for t in scene))
    with fake:
        state = init_state(fake_scene, cfg, "cpu")
        _, per_kernel = collect_elops(make_step_fn(cfg), state, fake_scene)
    return per_kernel


def device_name(dev: torch.device) -> str:
    """The card's name, or "cpu": every result names where it ran."""
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def roofline_report(res: int = 1600, scheme: str = "cip", steps: int = 100,
                    dtype: str = "float32", device: torch.device | str = "cuda") -> dict:
    """Steps/s of scene 2 at `res` (dye, confinement ε=5) against rooflines
    measured on `device`.

    Denominators: ``streaming_copy_GBps`` (probe C2 on 320 MB), each
    kernel's ``ceiling_GBps`` (probe C3, its operand mix at the real grid
    and at the transport `dtype`: at bf16 the bf16 twin) and
    ``fma_rate_Gelops`` (probe C4: float32, the kernels' arithmetic at
    either dtype, as ``fluid2d_tpu/utils/profiling.py:884,917`` keeps it). Per kernel: bytes per step, the
    ceiling, ``mem_floor_ms`` = bytes / ceiling, ``fma_floor_ms`` = counted
    el-ops / FMA rate, ``floor_ms`` = the larger, ``bound`` = which one.
    ``pct_of_geometry_roofline`` is the sum of the floors over the measured
    step; ``pct_of_copy_roofline`` the kernel bytes at the copy rate over it.

    Keys renamed from the JAX report, whose units were the TPU's:
    ``kernel_traffic_MB_per_step`` (JAX ``blockspec_traffic_MB_per_step``),
    ``mem_floor_ms`` (``dma_floor_ms``), ``fma_Gelops_per_step``,
    ``fma_floor_ms``, ``fma_rate_Gelops`` (``vpu_Gelops_per_step``,
    ``vpu_floor_ms``, ``vpu_rate_Gelops``), ``bound`` "mem" / "fma" ("dma" /
    "vpu"). The other keys mean what they mean there. On a CPU device
    ``hbm_note`` says the figures are approximate."""
    dev = torch.device(device)
    cfg = SimConfig.create(resolution=res, scheme=scheme, vor_eps=5.0, enable_dye=True,
                           dtype=dtype)
    scene = scene_for_dtype(get_scene(2, res, dev), cfg)
    x_rows, y_cols = scene.shape
    sec_per_step, _ = time_steps(make_run_fn(cfg), init_state(scene, cfg, dev), scene, steps)
    report: dict = {"device": device_name(dev)}
    if dev.type == "cuda":
        bw = measure_hbm_bandwidth(device=dev)
    else:
        bw = measure_hbm_bandwidth(mbytes=2, iters=10, device=dev)
        report["hbm_note"] = ("CPU device: the bandwidth is a plain x + 1 over a 2 MB buffer "
                              "and the ceilings time the twins' plain versions — cache "
                              "figures; treat the roofline percentages as approximate")
    min_bytes = step_min_bytes(cfg, x_rows, y_cols)
    per_kernel = step_kernel_bytes(cfg, res, 2, dev)
    elops = step_kernel_elops(cfg, res)
    fma_rate = measure_fma_throughput(device=dev)
    kernel_bytes = sum(per_kernel.values()) or min_bytes
    report |= {
        "steps_per_sec": 1.0 / sec_per_step,
        "ms_per_step": sec_per_step * 1e3,
        "streaming_copy_GBps": bw / 1e9,
        "min_traffic_MB_per_step": min_bytes / 2**20,
        "kernel_traffic_MB_per_step": kernel_bytes / 2**20,
        "copy_roofline_ms_per_step": kernel_bytes / bw * 1e3,
        "pct_of_copy_roofline": 100.0 * (kernel_bytes / sec_per_step) / bw,
    }
    kernels = {}
    floor_ms = 0.0
    for name, nbytes in sorted(per_kernel.items()):
        row: dict = {"MB_per_step": nbytes / 2**20}
        ceil_bps, _ = measure_mix_ceiling(name, x_rows, y_cols, device=dev, dtype=cfg.dtype)
        mem_floor = nbytes / ceil_bps * 1e3
        row |= {"ceiling_GBps": ceil_bps / 1e9, "mem_floor_ms": mem_floor}
        floor = mem_floor
        if fma_rate is not None and name in elops:
            fma_floor = elops[name] / fma_rate * 1e3
            row |= {"fma_Gelops_per_step": elops[name] / 1e9, "fma_floor_ms": fma_floor,
                    "bound": "fma" if fma_floor > mem_floor else "mem"}
            floor = max(mem_floor, fma_floor)
        row["floor_ms"] = floor
        floor_ms += floor
        kernels[name] = row
    report["kernels"] = kernels
    if fma_rate is not None:
        report["fma_rate_Gelops"] = fma_rate / 1e9
    if kernels:
        report["geometry_floor_ms_per_step"] = floor_ms
        report["pct_of_geometry_roofline"] = 100.0 * floor_ms / (sec_per_step * 1e3)
    return report


@contextlib.contextmanager
def trace(log_dir: str | Path):
    """``torch.profiler`` capture around a block (CPU, and the card's
    kernels when CUDA is available); writes a Chrome trace
    ``<log_dir>/trace.json`` and yields the profiler (``key_averages()``
    gives device time by kernel)."""
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(log_dir / "trace.json"))
