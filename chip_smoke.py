#!/usr/bin/env python3
"""Drive the PyTorch port of pencilarrays_tpu on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

It needs one CUDA card and ``nvcc``; it exits non-zero (printing no
result) when CUDA is unavailable, when run outside the repository, and
when any phase fails.  Phases, each printed on its own lines:

1. environment — card name and power limit (``nvidia-smi``), torch and
   CUDA versions, the kernel build time, a 1-rank NCCL process group;
2. kernel K1 (``pencilarrays_tpu_torch/ops/csrc/permute.cu``) against its
   plain PyTorch version on the card, bit for bit, over the main path's
   shapes, ragged shapes in six dtypes, and pack/unpack with P = 1, 2, 4;
   with kernel, plain, bound, copy and library times at each main-path
   shape and at two 512^3 hop classes;
3. an x->y->z->y->x transpose cycle of a 1024^3 float32 field on a (1, 1)
   topology: bit-identical round trip, GB/s;
4. a 512^3 r2c PencilFFT plan: forward + backward round trip and times;
5. Navier–Stokes (Taylor–Green): 64^3 on the card against the same port
   on the CPU, then 512^3 float32 for 3 RK2 steps (the main path), with
   the energy held to exp(-6 nu t), step time and peak memory;
6. a ``{"kernels": [...]}`` line: per kernel its launches on the main
   path, its error against the plain version and its times;
7. the last line, ``{"ok": true, "device": {...}}``.
"""

import json
import math
import os
import subprocess
import sys
import tempfile
import time

SEED = 0
H100_BW = {"H100 PCIe": 2.0e12, "H100 NVL": 3.9e12, "H200": 4.8e12}
H100_SXM_BW = 3.35e12  # bytes/s; also the default for an unlisted card


def log(*parts):
    print(*parts, flush=True)


def bandwidth(name: str) -> float:
    for key, bw in H100_BW.items():
        if key in name:
            return bw
    return H100_SXM_BW


def cuda_ms(torch, fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` launches (CUDA events,
    after one warm-up call)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def same_bits(torch, a, b) -> bool:
    return (a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().reshape(-1).view(torch.uint8),
        b.contiguous().reshape(-1).view(torch.uint8)))


def max_abs_err(torch, a, b) -> float:
    if a.is_complex():
        a, b = torch.view_as_real(a), torch.view_as_real(b)
    return float((a.double() - b.double()).abs().max())


def random_tensor(torch, shape, dtype, gen):
    if dtype.is_complex:
        real = torch.randn(shape, generator=gen, device="cuda")
        imag = torch.randn(shape, generator=gen, device="cuda")
        return torch.complex(real, imag).to(dtype)
    if dtype.is_floating_point:
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)
    return torch.randint(-2**30, 2**30, shape, generator=gen,
                         device="cuda").to(dtype)


# device kernels by the layer that launches them (substrings of the name)
KERNEL_GROUPS = [
    ("k1_permute", ("permute_tiled_kernel", "permute_copy_kernel")),
    ("cufft", ("fft", "FFT")),
    ("stack_cat", ("CatArrayBatchedCopy",)),
    ("exchange", ("nccl", "Memcpy")),
    ("elementwise", ("elementwise_kernel", "reduce_kernel")),
]


def profile(torch, fn, label: str, top: int = 8) -> dict:
    """Device time by kernel and by layer over one call of ``fn``
    (``torch.profiler``), with the device's busy share of the wall time."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or e.key.startswith("nccl:")):
            continue  # CPU ops and NCCL ranges repeat their kernels' time
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        if us > 0:
            rows.append((us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    groups = {}
    for ms, _, key in rows:
        group = next((g for g, words in KERNEL_GROUPS
                      if any(w in key for w in words)), "other")
        groups[group] = round(groups.get(group, 0.0) + ms, 3)
    out = dict(wall_ms=wall_ms, device_busy_ms=busy,
               busy_share=busy / wall_ms if wall_ms else 0.0, groups=groups,
               top=[(round(ms, 3), n, key[:70]) for ms, n, key in rows[:top]])
    log(f"[profile] {label}: " + json.dumps(out))
    return out


def phase_environment(torch, pat, k1, build, dist_dir):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    k1._lib()
    info = build.build_info["permute"]
    log(f"[env] permute.cu build {info['seconds']:.2f} s "
        f"(load {time.perf_counter() - t0:.2f} s)")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line:
            log(f"[env] ptxas: {line.strip()}")
    pat.distributed.initialize(
        "nccl", init_method=f"file://{os.path.join(dist_dir, 'rdv')}",
        world_size=1, rank=0)
    log("[env] nccl process group: world 1, rank 0")
    return smi


# K1 launches of the 512^3 NS step on a (1, 1) topology: each FFT stage
# moves the extra dims (3 or 6 components) outermost and back around cuFFT
MAIN_PATH = [
    ("NS stage 512x512x257x6 c64 (3,0,1,2)", (512, 512, 257, 6),
     (3, 0, 1, 2), "complex64"),   # backward chain of (u, omega), in
    ("NS stage 6x512^3 f32 (1,2,3,0)", (6, 512, 512, 512), (1, 2, 3, 0),
     "float32"),                   # backward chain of (u, omega), out
    ("NS stage 512^3x3 f32 (3,0,1,2)", (512, 512, 512, 3), (3, 0, 1, 2),
     "float32"),                   # forward chain of u x omega, in
    ("NS stage 3x512x512x257 c64 (1,2,3,0)", (3, 512, 512, 257),
     (1, 2, 3, 0), "complex64"),   # forward chain of u x omega, out
    ("NS stage 512x512x257x3 c64 (3,0,1,2)", (512, 512, 257, 3),
     (3, 0, 1, 2), "complex64"),   # energy: backward chain of u, in
    ("NS stage 3x512^3 f32 (1,2,3,0)", (3, 512, 512, 512), (1, 2, 3, 0),
     "float32"),                   # energy: backward chain of u, out
]
# the classes the port's hops give K1 on several ranks
HOPS = [
    ("512^3 f32 (2,0,1)", (512, 512, 512), (2, 0, 1), "float32"),
    ("512^3x6 c64 (1,2,0,3)", (512, 512, 512, 6), (1, 2, 0, 3), "complex64"),
]
MAIN_CASE = MAIN_PATH[0][0]


def phase_kernel(torch, k1, bw):
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    # bit-for-bit checks: main-path shapes, ragged shapes, pack/unpack
    checks = 0
    for _, shape, axes, dtype in MAIN_PATH + HOPS:
        x = random_tensor(torch, shape, getattr(torch, dtype), gen)
        if not same_bits(torch, k1.permute(x, axes), k1.permute_plain(x, axes)):
            raise AssertionError(f"permute {shape} {axes} {dtype} differs")
        checks += 1
        del x
    ragged = [(33, 17, 45, 3), (7, 1, 13), (5, 6, 7, 2), (129, 65, 31)]
    dtypes = [torch.float32, torch.float64, torch.complex64,
              torch.complex128, torch.bfloat16, torch.int32]
    for dtype in dtypes:
        for shape in ragged:
            x = random_tensor(torch, shape, dtype, gen)
            nd = len(shape)
            for axes in [tuple(reversed(range(nd))),
                         tuple(range(1, nd)) + (0,),
                         (nd - 1,) + tuple(range(nd - 1))]:
                if not same_bits(torch, k1.permute(x, axes),
                                 k1.permute_plain(x, axes)):
                    raise AssertionError(f"permute {shape} {axes} {dtype}")
                for dim in range(nd):
                    for P in (1, 2, 4):
                        got = k1.pack(x, axes, dim, P)
                        if not same_bits(torch, got,
                                         k1.pack_plain(x, axes, dim, P)):
                            raise AssertionError(
                                f"pack {shape} {axes} {dim} {P} {dtype}")
                        n = got.shape[0] * got.shape[dim + 1] - (P - 1)
                        for out_axes in (tuple(range(nd)), axes):
                            if not same_bits(
                                    torch, k1.unpack(got, out_axes, dim, n),
                                    k1.unpack_plain(got, out_axes, dim, n)):
                                raise AssertionError(
                                    f"unpack {shape} {out_axes} {dim} {P} "
                                    f"{dtype}")
                            checks += 1
    torch.cuda.synchronize()
    log(f"[k1] bit-identical to permute_plain on the card: {checks} cases "
        f"(the NS step's {len(MAIN_PATH)} shapes, {len(HOPS)} hop classes; "
        f"f32 f64 c64 c128 bf16 i32 ragged; pack/unpack P=1,2,4)")

    timed = {}
    for label, shape, axes, dtype in MAIN_PATH + HOPS:
        x = random_tensor(torch, shape, getattr(torch, dtype), gen)
        nbytes = x.numel() * x.element_size()
        dst = torch.empty_like(x)
        iters = 10
        r = dict(
            kernel_ms=cuda_ms(torch, lambda: k1.permute(x, axes), iters),
            plain_ms=cuda_ms(torch, lambda: k1.permute_plain(x, axes), iters),
            copy_ms=cuda_ms(torch, lambda: dst.copy_(x), iters),
            library_ms=cuda_ms(torch, lambda: x.permute(axes).contiguous(),
                               iters),
            bound_ms=2 * nbytes / bw * 1e3,
            max_abs_err=max_abs_err(torch, k1.permute(x, axes),
                                    k1.permute_plain(x, axes)),
            bytes=nbytes)
        r["kernel_GBps"] = 2 * nbytes / r["kernel_ms"] / 1e6
        timed[label] = r
        log(f"[k1] {label}: " + json.dumps(
            {k: (round(v, 4) if isinstance(v, float) else v)
             for k, v in r.items()}))
        del x, dst
        torch.cuda.empty_cache()
    # one RK2 step evaluates the nonlinear term twice; each evaluation
    # runs the first four main-path launches once
    step = {key: 2 * sum(timed[c[0]][key] for c in MAIN_PATH[:4])
            for key in ("kernel_ms", "plain_ms", "library_ms", "bound_ms")}
    log("[k1] per NS RK2 step (8 launches): " + json.dumps(
        {k: round(v, 4) for k, v in step.items()}))
    return timed


def phase_cycle(torch, pat, k1, tr):
    topo = pat.Topology((1, 1))
    shape = (1024, 1024, 1024)
    px = pat.Pencil(topo, shape, (1, 2), permutation=pat.Permutation(1, 2, 0))
    py = pat.Pencil(topo, shape, (0, 2), permutation=pat.Permutation(0, 2, 1))
    pz = pat.Pencil(topo, shape, (0, 1))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    x = pat.PencilArray(px, torch.randn(shape, generator=gen, device="cuda"))
    chain = [py, pz, py, px]

    def cycle():
        v = x
        for pen in chain:
            v = pat.transpose(v, pen)
        return v

    cycle()  # warm-up
    torch.cuda.synchronize()
    before = k1.launches
    t0 = time.perf_counter()
    back = cycle()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = k1.launches - before
    if not same_bits(torch, back.data, x.data):
        raise AssertionError("x->y->z->y->x round trip is not bit-identical")
    pens = [px] + chain
    nbytes = sum(tr.hop_operand_bytes(a, b, (), torch.float32)
                 for a, b in zip(pens, pens[1:]))
    wire = sum(sum(v["bytes"] for v in pat.transpose_cost(
        a, b, (), torch.float32).values()) for a, b in zip(pens, pens[1:]))
    log(f"[cycle] 1024^3 f32 (1,1) x->y->z->y->x bit-identical; "
        f"{secs * 1e3:.2f} ms, {nbytes / secs / 1e9:.1f} GB/s over "
        f"{nbytes} operand bytes (transpose_cost wire bytes {wire} on a "
        f"size-1 axis); K1 launches {launches}")
    profile(torch, cycle, "1024^3 f32 cycle (4 hops)")
    del x, back
    torch.cuda.empty_cache()
    return dict(ms=secs * 1e3, GBps=nbytes / secs / 1e9, launches=launches)


def phase_fft(torch, pat):
    topo = pat.Topology((1, 1))
    plan = pat.PencilFFTPlan(topo, (512, 512, 512), real=True,
                             dtype=torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    shape = plan.input_pencil.padded_size_local(pat.MemoryOrder)
    u = pat.PencilArray(plan.input_pencil,
                        torch.randn(shape, generator=gen, device="cuda"))
    plan.backward(plan.forward(u))  # warm-up (cuFFT plans)
    torch.cuda.synchronize()
    fwd, bwd = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        uh = plan.forward(u)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        back = plan.backward(uh)
        torch.cuda.synchronize()
        fwd.append((t1 - t0) * 1e3)
        bwd.append((time.perf_counter() - t1) * 1e3)
    err = float((back.data - u.data).abs().max())
    scale = float(u.data.abs().max())
    if not err <= 1e-5 * scale:
        raise AssertionError(f"FFT round trip error {err} > 1e-5 * {scale}")
    r = dict(forward_ms=min(fwd), backward_ms=min(bwd),
             roundtrip_max_err=err, max_abs_u=scale)
    log("[fft] 512^3 r2c f32 (1,1): " + json.dumps(r))
    del u, uh, back
    torch.cuda.empty_cache()
    return r


def phase_navier_stokes(torch, dist, pat, k1, models):
    # 64^3: the card against the same port on the CPU
    cpu_group = dist.new_group([0], backend="gloo")
    states = {}
    for dev, group in (("cuda", None), ("cpu", cpu_group)):
        topo = pat.Topology((1, 1), device=dev, group=group)
        m = models.NavierStokesSpectral(topo, 64, viscosity=1e-2)
        s = models.taylor_green(m)
        for _ in range(2):
            s = m.step(s, 5e-3)
        states[dev] = s.data.cpu()
    ref = states["cpu"]
    rel = float((states["cuda"] - ref).abs().max() / ref.abs().max())
    if not rel <= 1e-4:
        raise AssertionError(f"64^3 NS card vs CPU: rel error {rel}")
    log(f"[ns] 64^3 Taylor-Green, 2 RK2 steps: card vs CPU max-norm rel "
        f"error {rel:.3e} (<= 1e-4)")

    # 512^3 float32: the main path, with every kernel count reset first
    nu, dt, steps = 1e-2, 5e-3, 3
    topo = pat.Topology((1, 1))
    model = models.NavierStokesSpectral(topo, 512, viscosity=nu,
                                        dtype=torch.float32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k1.launches = 0
    uh = models.taylor_green(model)
    energies = [float(model.energy(uh))]
    step_ms, step_launches = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        n0 = k1.launches
        t0 = time.perf_counter()
        uh = model.step(uh, dt)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        step_launches.append(k1.launches - n0)
        energies.append(float(model.energy(uh)))
    launches = k1.launches
    peak = torch.cuda.max_memory_allocated()
    e0 = energies[0]
    devs = [abs(e / e0 - math.exp(-6 * nu * dt * i))
            for i, e in enumerate(energies)]
    log(f"[ns] 512^3 f32 Taylor-Green nu={nu} dt={dt}: energies "
        f"{energies}; |E/E0 - exp(-6 nu t)| {devs}")
    if not all(math.isfinite(e) for e in energies):
        raise AssertionError("non-finite energy")
    if not all(b < a for a, b in zip(energies, energies[1:])):
        raise AssertionError("energy does not decay monotonically")
    if not max(devs) <= 2e-5:
        raise AssertionError(f"energy off exp(-6 nu t) by {max(devs)}")
    shape = model.plan.output_pencil.padded_size_local(pat.MemoryOrder)
    if tuple(uh.data.shape) != tuple(shape) + (3,):
        raise AssertionError(f"state shape {tuple(uh.data.shape)}")
    r = dict(step_ms=step_ms, peak_bytes=peak, energies=energies,
             max_energy_dev=max(devs), k1_launches=launches,
             k1_launches_per_step=step_launches)
    log(f"[ns] step ms {[round(t, 2) for t in step_ms]}, peak memory "
        f"{peak / 2**30:.2f} GiB, K1 launches on the main path {launches} "
        f"({step_launches} per step)")
    if launches <= 0:
        raise AssertionError("the main path launched K1 no time")
    # after the counts were read: where one step's time goes
    profile(torch, lambda: model.step(uh, dt), "512^3 NS RK2 step")
    return r


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    import torch.distributed as dist

    import pencilarrays_tpu_torch as pat
    from pencilarrays_tpu_torch import models
    from pencilarrays_tpu_torch.ops import _build as build
    from pencilarrays_tpu_torch.ops import permute as k1
    from pencilarrays_tpu_torch.parallel import transpositions as tr

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as dist_dir:
        try:
            smi = phase_environment(torch, pat, k1, build, dist_dir)
            bw = bandwidth(smi)
            log(f"[env] bound uses {bw / 1e12:.2f} TB/s for '{smi}'")
            timed = phase_kernel(torch, k1, bw)
            phase_cycle(torch, pat, k1, tr)
            phase_fft(torch, pat)
            ns = phase_navier_stokes(torch, dist, pat, k1, models)
        finally:
            pat.distributed.finalize()
    main_case = timed[MAIN_CASE]
    kernels = [{
        "name": "permute",
        "route": "cuda",
        "source": "pencilarrays_tpu_torch/ops/csrc/permute.cu",
        "replaces": "pencilarrays_tpu/ops/pallas_kernels.py:98",
        "launches": ns["k1_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in timed.values()),
        "ms": main_case["kernel_ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": "bytes",
        "library_ms": main_case["library_ms"],
        "checked": True,
        "shape": MAIN_CASE,
    }]
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
