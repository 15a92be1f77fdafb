#!/usr/bin/env python3
"""Drive the PyTorch port of pencilarrays_tpu on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

It needs one CUDA card and ``nvcc``; it exits non-zero (printing no
result) when CUDA is unavailable, when run outside the repository, and
when any phase fails, and then prints the reason (or the traceback) on
standard output too.  Phases, each printed on its own lines:

1. environment — card name and power limit (``nvidia-smi``), torch and
   CUDA versions, the kernel build time, each K2–K4 kernel's registers
   and spill bytes (``-Xptxas -v``), a ``cuobjdump -sass`` check that
   every wgmma kernel of K2, K3 and K4 holds HGMMA and UTMALDG
   instructions and spills nothing, and every tf32x3 kernel of K3 and K4
   TF32 HMMA ones, spilling no more than it did when tuned; a 1-rank
   NCCL process group;
2. kernel K1 (``pencilarrays_tpu_torch/ops/csrc/permute.cu``) against its
   plain PyTorch versions on the card, bit for bit, over the main path's
   shapes, ragged shapes in six dtypes, pack/unpack with P = 1, 2, 4,
   each instance (copy, narrow, tiled) at its edges, the chunk views of
   a Pipelined hop (ragged tail chunks, a chunk along an extra dim,
   strided sources and destinations at storage offsets that keep 16-byte
   alignment and ones that do not) and one launch over more than 2^31
   words; its timings run last (after phase 9): kernel, call, plain,
   bound, copy and library times and the instance of every (shape, axes,
   dtype, view layout) class phases 3, 4, 5, 5i, 5j and 7 launched
   (recorded by ``permute.recorded``; a class only phase 5i launched
   over 3 launches; the process groups of the phases before released
   first) and of two 512^3 hop classes, and K1's time per
   run (per NS RK2 step, per cycle and method, per Ulysses call);
3. an x->y->z->y->x transpose cycle of a 1024^3 float32 field on a (1, 1)
   topology under AllToAll(), Ring(), Pipelined(4) and Pipelined(3,
   Ring()): every hop bit-identical to the AllToAll hop, bit-identical
   round trips, ms, GB/s, K1 launches by instance, K1 bytes (equal for
   every method, or the run fails), exchange calls and one profile each;
3w. reduced-precision wires, Gspmd and reshard: ``wire.pack``/``unpack``
   on the card byte for byte against the port on the CPU (every wire on
   f32, f64, c64 and c128, ragged tails, NaN/inf/-0/subnormal edges); the
   1024^3 cycle under AllToAll at each of the four wires, Ring(bf16) and
   Pipelined(4, AllToAll(fp8_e4m3)): each hop bit-identical to the
   unwired hop on ``unpack(pack(x))``, K1 launches equal to the unwired
   cycle's and K1 bytes too (half of them on a 16-bit wire, which casts
   before K1's pack), exchange bytes equal to the cost model's operands,
   the content sum within ``wire_rtol``, ms, peak and a profile (K1,
   exchange, cast); at 64^3 the card's wired cycles equal the CPU's; a
   1024^3 ``reshard`` between pencils differing in both slots and memory
   order (default, Gspmd, forced AllToAll, bf16, fp8 e4m3,
   Pipelined(4), ``hbm_limit``, ``ManyPencilArray.reshard_to``), each
   bit-identical to Gspmd (a wired route within two steps of its wire),
   with ms, K1 launches and peak beside the route's modeled
   ``peak_hbm_bytes`` (the ``hbm_limit`` run, the bf16 route and the
   Pipelined(4) route must keep it, less the resident input);
4. a 512^3 r2c PencilFFT plan: forward + backward round trip and times;
   a strided-batch ``rfftn``/``irfftn`` over a (512, 512, 512, 3) f32
   block with the components innermost against K1 + the contiguous
   transform + K1; the fused pipelined hop (K = 4) called directly on the
   NS plan's first hop operand, forward and inverse, against the
   serialized hop and stage (data movement bit for bit, the transform
   within 1e-6 of max|u_hat|), with times; a ("dct", "fft", "fft") plan
   over 3 fields at 512^3 (round trip within 1e-5 of max|u|, times) and
   at 64^3 against the port on the CPU;
5. Navier–Stokes (Taylor–Green): 64^3 on the card against the same port
   on the CPU, ``simulate`` (3 steps, energies recorded) against three
   ``step`` calls, then 512^3 float32 for 3 RK2 steps (the main path),
   with the energy held to exp(-6 nu t), step time and peak memory;
5b. the grid toolbox and the halo-exchange path: three HeatFD RK2 steps
   at 1024^3 f32 against the scheme's exact discrete answer (64^3 card
   against the CPU), step ms beside the fused bound, peak memory and a
   profile; adaptive RK23 of the same model at 512^3 (accepted and
   rejected steps, ms a trial; at 64^3 the card's decisions equal the
   CPU's); sum, norm, maximum, dot and any(isnan) over the 1024^3 field
   against float64, beside their bytes-bound; uniform and normal fills at
   1024^3 (uniform bit-identical to the CPU's at 64^3); the spectral
   operators on the 512^3 NS plan against analytic answers, with K1's
   launches; a ManyPencilArray cycle at 1024^3 bit-identical to phase
   3's hops, beside the transpose chain (ms, K1 launches, peak);
5c. parallel I/O and crash-safe checkpoints, in ``chip_smoke_io/`` of the
   checkout (which must hold three times the bytes the phase writes;
   deleted at the end): a 1024^3 f32 field written by ``BinaryDriver``
   from a z-pencil, discontiguous and in the chunks layout, each read
   back into phase 3's x-pencil bit for bit, with write and read ms and
   GB/s by stage (K1, device-host copy, native pwrite/pread, fsync) and
   the native library as the path (or the phase fails); NS Taylor-Green
   at 512^3 saved after each of 3 RK2 steps by ``CheckpointManager
   (keep=2)``: steps [2, 3], a restore of step 2 stepped once against
   the uninterrupted step 3, step 3 read into another pencil against
   ``transpose``, save ms by stage, its peak above the state (at most
   one component's staged block), restore ms with and without
   verification; four drills in subprocesses (a kill before the commit,
   two retried sidecar-flush faults, a flipped byte refused by name, an
   armed ``hop.exchange``); HDF5 when h5py imports and a 256^3 Orbax-layout
   round trip (``io.OrbaxDriver``) when tensorstore imports (each printed
   either way);
5d. the engine (``engine/``), in ``chip_smoke_engine/`` of the checkout
   (three times the bytes it writes must be free; deleted at the end):
   NS Taylor-Green at 512^3 for 16 RK2 steps with a
   ``CheckpointManager(keep=2)`` save every 8, once as a synchronous
   loop and once by ``run_async`` (saves on the engine's host pool): the
   final states and the kept steps restored from both directories bit
   for bit, the saves counted as host tasks, the dispatch log verified
   (``analysis.verify_dispatch_log``), wall ms of both loops and the share
   of the save time hidden, the median step inside the async loop, its
   peak above the sync loop's (at most one state and one staged
   component); ``step_async``, ``forward_async`` and ``backward_async``
   bit-identical to the synchronous calls; ``compile()`` of the NS plan
   as one CUDA graph per direction, bit-identical to the eager chain,
   one replay per call and no eager launch, the graph's pool bytes and
   captured K1 launches, eager against compiled ms with the copies in
   and out timed apart; an 8-step ``run_async`` with one save under
   ``PENCILARRAYS_TPU_OBS`` whose journal lints clean and holds the
   ``ckpt.save`` records and the engine's gauges, step ms with obs on
   and off; ``utils/benchtime`` on phase 3's cycle with its spread, and
   ``Auto(mode="measure")`` resolving every one-card hop unmeasured;
5e. the runtime guard and the rest of obs/ (``guard/``, ``obs/``), in
   ``chip_smoke_guard/`` of the checkout (deleted at the end): phase 3's
   1024^3 cycle under AllToAll() and Ring() with the guard on, every hop
   bit-identical to the unguarded hop, K1 launches by instance and K1
   bytes equal to phase 3's, one ``guard.checks{outcome="ok"}`` per hop,
   the guarded cycle's peak at most 0.5 GiB above the unguarded one's,
   ms (median of 3) each way; the bf16 wired cycle guarded, and its hop
   under a wire-rtol override far below bf16's quantization raising
   ``WirePrecisionError`` (a ``guard.sdc`` record of kind ``wire``, a
   bundle); NS Taylor-Green 512^3 f32, 8 RK2 steps with the guard on
   (the finiteness tap on every plan call) and 8 with it off, the same
   bits and K1 launches, ms a step each way; the drills, each raising
   its typed error: ``hop.exchange:corrupt`` on a 1024^3 hop
   (``IntegrityError``, ``guard.sdc``, a bundle holding the plan
   fingerprints; guard off, the poke lands on the JAX package's element),
   ``ckpt.restore:corrupt`` on the 512^3 NS state (caught by the
   finiteness boundary check), ``guarded_step`` over NS steps with a
   ``CheckpointManager`` surviving a corrupt hop by retry and another by
   restoring (final state = the uninterrupted run's bits), and
   ``hop.exchange:delay`` past a short watchdog deadline
   (``HangTimeoutError`` with a bundle); ``measure_transpose`` on 1024^3
   hops with the drift report, a 1024^3 reshard route planned with
   trusted drift (a ``route.plan`` record), ``merge_journals`` and
   ``write_trace`` on the phase's journal, ``python -m
   pencilarrays_tpu_torch.obs`` lint, merge and trace (exit 0),
   ``reconstruct_request`` of one ``run_async`` dispatch,
   ``MeshAggregator`` over ``FileKV`` at world 1 (``rank`` labels) and the
   straggler rule on one rank (skipped); prints ``[guard]`` and ``[obs]``
   lines;
5f. (run right after phase 1, while this process holds little of the card)
   the cluster layer as the JAX package's multi-process recovery drills,
   each rank a process of its own on the card (a one-rank NCCL world on a
   (1, 1) topology, ``tests/torch_cluster_worker.py``), joined only by a
   ``FileKV`` under ``chip_smoke_cluster/`` (deleted after); the drill step
   is one NS RK2 step at 512^3 f32 and an x->y->x round trip of the state.
   At world 2: ``sdc`` (an agreed retry, then an agreed restore of step 1,
   bit-identical), ``kill`` (a typed ``PeerFailureError`` naming rank 0
   within the lease deadline, with a bundle), ``restore`` (fresh processes
   elect and restore step 1), ``elastic`` against ``elastic_ref`` (rank 1
   killed mid-step 3, the survivor reforms to world 1, rebuilds its
   registered plan, restores step 2 and ends with the uninterrupted run's
   digest; its reformation timings, and a ``PlanService`` riding the
   drill: two host requests queued before the kill drain after the
   reformation, ``SERVE_RESUMED=2``), ``storm`` (each rank's service sheds
   4 sheddable reshards typed at submit, rank 1 is killed inside the
   storm batch, the survivor reforms and serves its 4 protected reshards
   bit-identical), ``scale`` at 256^3 (idle scale-down by
   ``announce_leave``, the leaver rejoins pre-warmed, admitted by the
   scale-up); then ``elastic`` at world 4 and 256^3 (world 4 -> 3); each
   rank reports the K1 classes it launched, timed in phase 2 under the
   path ``cluster``; prints ``[cluster]`` lines;
5g. (run right after 5f) the plan service (``serve/``) at BASELINE config
   3, the 512^3 r2c f32 PencilFFT, on a (1, 1) topology: tenants ``a`` (8
   host forwards), ``b`` (8 host backwards), ``c`` (8 device forwards),
   ``d`` (4 reshards of 512^3 f32 between two pencils), submitted tenant
   by tenant, coalesced (``max_batch=8``) and serialized
   (``max_batch=1``), each after a warm-up pass that captures every batch
   size: requests/s, dispatches per key (coalesced: 2, 1, 1), per-tenant
   p50/p99, each batch's host pack, host-to-device, stack and split
   seconds, K1 launches by instance, the peak above the idle service,
   every graph variant's pool bytes; every result owns its storage, one
   sample's size, and equals its sequential call (reshards bit for bit,
   FFTs within ``PSVC_FFT_TOL`` of max|u_hat|: cuFFT's batched plan rounds
   apart); the drills: ``hop.exchange:corrupt`` with the guard armed
   fails exactly ``d``'s tickets typed while ``a``'s and ``c``'s batch
   completes, an overload sheds the sheddable tier typed at submit while
   the protected one completes under its deadline, bf16 and fp8 rungs
   serve reshards within their envelopes, the journal lints clean and
   ``python -m pencilarrays_tpu_torch.obs request`` reconstructs a
   coalesced request; K1's split and stack timed against their bound;
   prints ``[plan_service]`` lines;
5h. (run right after 5g) the fleet (``fleet/``) and the rest of
   ``analysis/``: two mesh processes of ``tests/torch_fleet_worker.py``
   share the card behind a router in this process (no device, joined by
   a ``FileKV``), each serving the 512^3 r2c f32 ``whale`` and the 128^3
   ``minnow`` through a ``PlanService`` (``max_batch=4``): a timed storm
   (tenants ``a``: 1 whale forward, ``b``: 1 whale backward, ``c``: 16
   minnow forwards; a whale's capsule takes the router about 10 s to
   encode, and the run's time allows one of each) with requests/s, per-tenant p50/p99, per whale
   request the seconds of each part of the wire (the router's encode and
   KV write, the worker's decode, the service, the result's encode and
   KV write, the router's decode), placements per mesh, each worker's K1
   launches, peak above its idle service and graph pool bytes, the card
   kept at least ``FLEET_FREE_BYTES`` free, every result within
   ``PSVC_FFT_TOL`` of its sequential call; drills at 256^3 (whole-mesh
   loss by ``fleet.route:kill%mesh1@4`` with detect, rebind and resolve
   times; a router process SIGKILLed at its 7th admission and its WAL
   replayed, each committed admission resolved once; a retire by the
   stop key seen as ``MeshLeftError``), the merged journal linted and a
   rebound request reconstructed; each worker's ``certify`` of its
   resident variants (predicted peak beside the measured one); the
   port's ``pa-lint`` over the repo; the workers' K1 classes are timed
   in phase 2 under the path ``fleet``; prints ``[fleet]`` lines;
5i. (run after 5e, the process groups of the phases before released)
   gradients on the card (``phase_autodiff``), each
   path's K1 launches forward and backward: the gradient of sum(v*v)
   through the 1024^3 f32 reshard by the default method and by a forced
   ``AllToAll()`` route (folded into one K1 permute), 2u bit for bit;
   512^3 f32 plans over 3 components, c2c against Parseval (2 N u) and
   the r2c round trip against w, within 1e-5; one NS RK2 step in f64 at
   64^3 against a central difference (1e-4), eager in f32 at 256^3 (and
   at 512^3 where 8 times that peak stays under 70 GiB), and at 512^3
   under ``torch.utils.checkpoint`` bit for bit against the same
   gradient with the plain moves (ms, peak); the 1024^3 cycle in f16,
   int16, int64, uint8, bool and c128 (every hop bit-identical, ms, K1
   instance); ragged f16/bf16/int16/uint8 maximum and minimum; a
   (1, 1, 1) topology's M = N permutation change and BASELINE config 4
   (a 4 GiB 4-D c64 array, M = 2, permuted), bit for bit; one
   ``Pencil.similar``; then K1's backward against the plain inverse
   permute at every permute class launched backward; prints
   ``[autodiff]`` lines;
5j. the user entry points (``phase_examples``, in the process without
   its NCCL world, as one process runs them): each of the nine
   ``pencilarrays_tpu_torch/examples`` modules' ``run()`` at its card
   default (the quickstart walkthrough at (42, 31, 29); the spectral
   gradient, Navier–Stokes checkpoint and restart, adjoint
   optimization, heat stencil, checkpoint collection and observability
   demo at 512^3; attention and training at S = 4096, H = 8, D = 128 in
   f32 and bf16), each with its own asserts, then ``entry()`` and
   ``dryrun(1)`` (no byte across ranks); each example's wall seconds,
   checks and K1–K4 launches (paths ``examples.<name>``,
   ``entry.dryrun``); then each at a small shape on the card against
   the same on the CPU (which launches no kernel); files in
   ``chip_smoke_examples/``, deleted after; the NCCL world made again
   after it; prints ``[examples]`` lines;
6. kernels K2–K4 (``ops/csrc/flash_fwd.cu``, ``flash_bwd.cu``,
   ``flash_bwd_tf32.cu``) against their plain versions on the card: three
   forward modes, full and partials backward, causal and not, ragged
   lengths, offsets, rows with no visible key, f32 and bf16, head dims 40
   to 1024, P = 4 naive and zigzag causal rings emulated at kernel level,
   and flash attention on q/k/v of mixed dtypes, each row held relative
   to its own scale (rows of m, dq and dk to their largest term where it
   is larger: a sum that cancels is held to its rounding); every K3/K4 call launches the instance
   ``bwd_instance`` picks (D <= 256: wgmma for all-bf16 operands, tf32x3
   for any f32 one; simt above); then the tensor-core instances at their
   edges, in bf16 (K2–K4's wgmma) and in f32 (K3/K4's tf32x3): head dims
   40 to 256, Sq < 64, Skv = 1, ragged Skv, k/v views with a storage
   offset, aligned and not;
7. serving at full width (S = 4096, H = 8, D = 128): Ulysses and causal
   ring attention over NCCL on a (1,) topology, f32 and bf16, each held
   to dense attention, with the K1/K2 launches of each call and K2's by
   instance (bf16 calls launch only the wgmma one, f32 only the simt one);
8. training: the block of ``examples/long_context_training.py``,
   through its port (``pencilarrays_tpu_torch/examples/
   long_context_training.py``), at full width (causal ring attention, which runs the naive schedule on one
   rank; MSE; SGD) for 3 steps, in f32 and in bf16 (f32 master weights,
   bf16 projections and attention): the loss falls, one step's gradients
   match the plain path, K2–K4 launched by the wgmma instances in bf16,
   K2's simt and K3/K4's tf32x3 ones in f32;
9. K2–K4 times at the headline shape, f32 and bf16, causal and not:
   kernel, plain, SDPA (a yardstick the port never calls; the CUDA
   kernels it launches, from the profiler) and bound, each kernel by the
   instance its dtype picks, held to the plain version; then the simt
   instances at D = 512 (the head dims above 256 they serve), f32 and
   bf16 operands, non-causal, SDPA by its default dispatch (flash and
   cuDNN refuse D = 512; the memory-efficient backend takes it);
10. a ``{"kernels": [...]}`` line: per kernel its launches on each path
    (each counted from 0 just before its run; K1's on the NS steps, the
    four cycles, the six wired cycles, the reshard runs, the fused hop, the DCT plan, the spectral operators,
    the ManyPencilArray cycle, phase 5c's writes and reads, ``io``,
    phase 5d's ``engine_ns`` and ``compiled_plan``, phase 5e's
    ``guard_cycle``, ``guard_ns``, ``guard_drills`` and ``obs_rest``,
    phase 5f's rank processes, ``cluster``, phase 5g's wrapper
    launches, ``plan_service``, phase 5h's mesh processes, ``fleet``,
    phase 5i's ``grad_reshard``, ``grad_fft``, ``grad_ns``,
    ``grad_ns_checkpoint``, ``dtypes`` and ``topo3``, and phase 5j's
    ``examples.<name>`` and ``entry.dryrun``) and their sum, by
    instance, its error against the plain version and its times (K1's per
    class in ``timings``);
11. the last line, ``{"ok": true, "device": {...}}``.
"""

import faulthandler
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

SEED = 0
WATCHDOG_S = 1080   # the run's own limit, under the 1200 s it must keep
KERNEL_SOURCES = ["permute", "flash_fwd", "flash_bwd", "flash_bwd_tf32"]
H100_BW = {"H100 PCIe": 2.0e12, "H100 NVL": 3.9e12, "H200": 4.8e12}
H100_SXM_BW = 3.35e12  # bytes/s; also the default for an unlisted card
# phase 5i's paths (their classes alone are timed over 3 launches)
AUTODIFF_PATHS = ("grad_reshard", "grad_fft", "grad_ns",
                  "grad_ns_checkpoint", "dtypes", "topo3")


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


def release_groups(torch, label):
    """Destroy every process group but the default one, and the port's
    caches that hold topologies (``cluster.elastic.clear_plan_caches``):
    each one-rank NCCL communicator holds hundreds of MiB of the card
    outside PyTorch's allocator (two per ``Topology((1, 1))``), and the
    phases before 5i make dozens of them; the line printed says what
    was freed.  Only between phases: the topologies of the phases
    before are dead after it."""
    import torch.distributed as dist
    from pencilarrays_tpu_torch.cluster import elastic

    gc.collect()
    torch.cuda.synchronize()
    free0, _ = torch.cuda.mem_get_info()
    cached = elastic.clear_plan_caches()
    world = dist.group.WORLD
    groups = [g for g in list(dist.distributed_c10d._world.pg_map)
              if g is not world]
    for g in groups:
        dist.destroy_process_group(g)
    torch.backends.cuda.cufft_plan_cache.clear()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    free, total = torch.cuda.mem_get_info()
    reserved = torch.cuda.memory_reserved()
    log(f"[{label}] released {len(groups)} process groups and {cached} "
        f"cached plans: free on the card {_gib(free0):.2f} -> "
        f"{_gib(free):.2f} of {_gib(total):.2f} GiB, "
        f"{_gib(reserved):.2f} reserved by PyTorch, "
        f"{_gib(total - free - reserved):.2f} outside it")


def same_bits(torch, a, b) -> bool:
    return (a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().reshape(-1).view(torch.uint8),
        b.contiguous().reshape(-1).view(torch.uint8)))


def max_abs_err(torch, a, b) -> float:
    """max|a - b| in float64, 2^27 elements at a time (a 12 GiB pair
    needs no 36 GiB of temporaries, whatever its leading dim)."""
    if a.is_complex():
        a, b = torch.view_as_real(a), torch.view_as_real(b)
    a, b = a.reshape(-1), b.reshape(-1)
    step = 1 << 27
    return max((float((a[i:i + step].double() - b[i:i + step].double())
                      .abs().max()) for i in range(0, a.numel(), step)),
               default=0.0)


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
    ("k2_flash_fwd", ("flash_fwd_wgmma_kernel", "flash_fwd_simt_kernel")),
    ("k3_flash_dq", ("flash_dq_wgmma_kernel", "flash_dq_tf32x3_kernel",
                     "flash_dq_kernel")),
    ("k4_flash_dkv", ("flash_dkv_wgmma_kernel", "flash_dkv_tf32x3_kernel",
                      "flash_dkv_kernel")),
    ("k1_permute", ("permute_",)),
    ("gemm", ("gemm", "xmma", "cutlass", "Kernel2")),
    ("cufft", ("fft", "FFT")),
    ("stack_cat", ("CatArrayBatchedCopy",)),
    ("exchange", ("nccl", "Memcpy")),
    ("elementwise", ("elementwise_kernel", "reduce_kernel")),
]


def _kernel_rows(torch, fn):
    """One call of ``fn`` under ``torch.profiler``: its wall ms and the
    CUDA kernels it ran, ``(device ms, count, name)`` by time."""
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
    return wall_ms, rows


def profile(torch, fn, label: str, top: int = 8, extra_groups=()) -> dict:
    """Device time by kernel and by layer over one call of ``fn``
    (``torch.profiler``), with the device's busy share of the wall time;
    ``extra_groups`` are matched before ``KERNEL_GROUPS``."""
    wall_ms, rows = _kernel_rows(torch, fn)
    busy = sum(r[0] for r in rows)
    groups = {}
    for ms, _, key in rows:
        group = next((g for g, words in (*extra_groups, *KERNEL_GROUPS)
                      if any(w in key for w in words)), "other")
        groups[group] = round(groups.get(group, 0.0) + ms, 3)
    out = dict(wall_ms=wall_ms, device_busy_ms=busy,
               busy_share=busy / wall_ms if wall_ms else 0.0, groups=groups,
               top=[(round(ms, 3), n, key[:70]) for ms, n, key in rows[:top]])
    log(f"[profile] {label}: " + json.dumps(out))
    return out


def phase_environment(torch, pat, build, dist_dir):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    build.build_all(KERNEL_SOURCES)   # one nvcc per source, all at once
    log(f"[env] kernel build {time.perf_counter() - t0:.2f} s wall: " + ", ".join(
        f"{name}.cu {build.build_info[name]['seconds']:.2f} s"
        for name in KERNEL_SOURCES))
    for name in KERNEL_SOURCES:
        for line in build.build_info[name]["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"[env] ptxas {name}: {line.strip()}")
    instances = flash_instances(build)
    pat.distributed.initialize(
        "nccl", init_method=f"file://{os.path.join(dist_dir, 'rdv')}",
        world_size=1, rank=0)
    log("[env] nccl process group: world 1, rank 0")
    return smi, instances


def _ptxas_report(log_text: str) -> dict:
    """Per entry function of a ``-Xptxas -v`` log: registers and spill
    bytes."""
    out, name = {}, None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            out[name] = {}
        elif name and "spill stores" in line:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            out[name].update(spill_stores=int(m.group(1)),
                             spill_loads=int(m.group(2)))
        elif name and "Used" in line and "registers" in line:
            out[name]["registers"] = int(
                re.search(r"Used (\d+) registers", line).group(1))
    return out


def _kernel_label(mangled: str) -> str:
    """``flash_fwd_wgmma_kernel<128,128>`` from a mangled K2–K4 name."""
    base = re.search(r"flash_\w+?_kernel", mangled).group(0)
    nums = ",".join(re.findall(r"Li(\d+)E", mangled))
    return f"{base}<{nums}>"


# the flash kernels of each library, by the kernel they implement
FLASH_LIBS = {"flash_fwd": {"k2": "flash_fwd_"},
              "flash_bwd": {"k3": "flash_dq_", "k4": "flash_dkv_"},
              "flash_bwd_tf32": {"k3": "flash_dq_", "k4": "flash_dkv_"}}
# SASS each tensor-core instance must hold: wgmma (HGMMA) on TMA tile loads
# (UTMALDG); mma.sync on TF32 operands (HMMA ... TF32)
SASS_WANT = {"wgmma": ["HGMMA", "UTMALDG"], "tf32x3": ["HMMA.TF32"]}
# spill bytes (stores + loads) each instance's kernels of K2–K4 may total:
# none for wgmma; for tf32x3 what ptxas 12.8 gave when the kernels were
# tuned (K3 4 + 4 at D = 256, K4 16 + 20 at D = 128), so that growth fails
SPILL_LIMIT = {"wgmma": {"k2": 0, "k3": 0, "k4": 0},
               "tf32x3": {"k3": 8, "k4": 36}}


def _sass_ops(line: str) -> set:
    ops = {w for w in ("HGMMA", "UTMALDG") if w in line}
    if "HMMA" in line and "TF32" in line:
        ops.add("HMMA.TF32")
    return ops


def flash_instances(build) -> dict:
    """Each K2–K4 kernel's registers and spill bytes, and a ``cuobjdump
    -sass`` check: every wgmma kernel must hold HGMMA (wgmma) and UTMALDG
    (TMA tile load) instructions, every tf32x3 kernel TF32 HMMA (mma.sync)
    ones, and each instance's kernels of a kernel K spill no more than
    SPILL_LIMIT allows.  Returns
    ``{"k2": {label: report}, "k3": ..., "k4": ...}``."""
    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    out = {}
    for lib, kernels in FLASH_LIBS.items():
        info = build.build_info[lib]
        regs = _ptxas_report(info["log"])
        sass = subprocess.run([cuobjdump, "-sass", info["path"]],
                              capture_output=True, text=True, check=True,
                              timeout=300).stdout
        ops, name = {}, None
        for line in sass.splitlines():
            if "Function :" in line:
                name = line.split("Function :")[1].strip()
                ops[name] = set()
            elif name:
                ops[name].update(_sass_ops(line))
        for mangled in sorted(set(regs) | set(ops)):
            key = next((k for k, prefix in kernels.items()
                        if prefix in mangled), None)
            if key is None:
                continue
            r = dict(regs.get(mangled, {}), sass=sorted(ops.get(mangled, ())))
            out.setdefault(key, {})[_kernel_label(mangled)] = r
            log(f"[env] {key.upper()} {_kernel_label(mangled)}: "
                f"{json.dumps(r)}")
    for inst, want in SASS_WANT.items():
        for key, limit in SPILL_LIMIT[inst].items():
            mine = {k: r for k, r in out.get(key, {}).items() if inst in k}
            spills = sum(r.get("spill_stores", 0) + r.get("spill_loads", 0)
                         for r in mine.values())
            if not mine or any(r["sass"] != want for r in mine.values()) or (
                    spills > limit):
                raise AssertionError(f"{key.upper()} {inst} instance lacks "
                                     f"{want} or spills more than {limit} "
                                     f"bytes: {mine}")
            log(f"[env] SASS: {len(mine)} {inst} kernels of {key.upper()} "
                f"hold {' and '.join(want)}, {spills} spill bytes (stores + "
                f"loads; at most {limit})")
    return out


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


# K1 at the edges of its instances: every short-dim extent C, runs that
# are not multiples of 4 or of a tile, pack and unpack with P = 1, 2, 4 on
# ragged extents, each element size (bool included), and an input whose
# storage offset breaks 16-byte alignment
K1_EDGE_C = (1, 2, 3, 5, 6, 7, 16)
K1_EDGE_DTYPES = ("float32", "complex64", "bfloat16", "uint8", "complex128",
                  "float64", "bool")


def _k1_same(torch, k1, what, x, axes, dim=None, P=None):
    """``x`` through permute, and pack + unpack on (dim, P), against the
    plain versions; returns the number of comparisons."""
    def check(tag, got, want):
        if not same_bits(torch, got, want):
            raise AssertionError(f"K1 {tag} {what} {tuple(x.shape)} {axes} "
                                 f"{x.dtype} dim={dim} P={P} differs")

    check("permute", k1.permute(x, axes), k1.permute_plain(x, axes))
    if dim is None:
        return 1
    got = k1.pack(x, axes, dim, P)
    check("pack", got, k1.pack_plain(x, axes, dim, P))
    n = got.shape[0] * got.shape[dim + 1] - (P - 1)
    for out_axes in (tuple(range(x.dim())), axes):
        check("unpack", k1.unpack(got, out_axes, dim, n),
              k1.unpack_plain(got, out_axes, dim, n))
    return 4


def k1_edges(torch, k1, gen):
    """Every K1 instance against the plain versions at its edges; returns
    ``(comparisons, launches by instance)``.  Raises on any difference."""
    def rnd(shape, name):
        if name == "bool":
            return torch.rand(shape, generator=gen, device="cuda") > 0.5
        if name == "uint8":
            return torch.randint(0, 256, shape, generator=gen,
                                 device="cuda").to(torch.uint8)
        return random_tensor(torch, shape, getattr(torch, name), gen)

    by0 = dict(k1.launches_by_instance)
    n = 0
    for name in K1_EDGE_DTYPES:
        for C in K1_EDGE_C:
            # interleave (C innermost -> outermost) and back, over runs of
            # 96 x 53 = 5088 positions (whole 16-byte groups: narrow warp
            # tiles, the last one short) and 97 x 53 = 5141 (ragged: flat
            # tiled tiles)
            for shape, axes in (((96, 53, C), (2, 0, 1)),
                                ((C, 96, 53), (1, 2, 0)),
                                ((97, 53, C), (2, 0, 1)),
                                ((C, 97, 53), (1, 2, 0))):
                x = rnd(shape, name)
                n += _k1_same(torch, k1, "narrow", x, axes)
                for dim, P in ((0, 2), (1, 4), (2, 1)):
                    n += _k1_same(torch, k1, "narrow", x, axes, dim, P)
        # tiled: ragged 2-D and 3-D transposes of several tiles (the ring),
        # and whole tiles (a warp a tile: 128-byte rows of 4- to 16-byte
        # elements, 8 x 8 elements of 2 to 7 16-byte words)
        for shape, axes in (((300, 201), (1, 0)), ((129, 65, 31), (2, 0, 1)),
                            ((129, 65, 31), (0, 2, 1)),
                            ((33, 17, 45, 6), (1, 2, 0, 3)),
                            ((96, 64), (1, 0)), ((3, 64, 32), (0, 2, 1)),
                            ((16, 8, 6), (1, 0, 2))):
            x = rnd(shape, name)
            n += _k1_same(torch, k1, "tiled", x, axes)
            for dim, P in ((0, 4), (1, 2), (len(shape) - 1, 1)):
                n += _k1_same(torch, k1, "tiled", x, axes, dim, P)
    # inputs 4 bytes past a 16-byte boundary: word-sized chunks
    for shape, axes in (((97, 53, 3), (2, 0, 1)), ((3, 97, 53), (1, 2, 0)),
                        ((129, 65, 31), (2, 0, 1)), ((64, 64, 64), (0, 1, 2))):
        numel = math.prod(shape)
        x = rnd((numel + 1,), "float32")[1:].view(shape)
        if x.data_ptr() % 16 == 0:
            raise AssertionError("misaligned view is aligned")
        n += _k1_same(torch, k1, "misaligned", x, axes)
        n += _k1_same(torch, k1, "misaligned", x, axes, 0, 2)
    torch.cuda.synchronize()
    by = {i: k1.launches_by_instance[i] - by0[i] for i in by0}
    return n, by


# K1 on a Pipelined hop's chunks: (shape, axes, chunk dim) — chunks in K = 3
# ceil pieces (a short tail chunk where 3 does not divide the extent),
# along a spatial dim and along an extra dim (the components)
K1_CHUNKS = [((129, 65, 31), (2, 0, 1), 1), ((96, 64, 40), (0, 2, 1), 0),
             ((64, 48, 40, 6), (1, 2, 0, 3), 3),
             ((64, 48, 40, 3), (2, 0, 1, 3), 1), ((80, 33, 64), (1, 0, 2), 2)]
K1_CHUNK_DTYPES = ("float32", "complex64", "bfloat16", "float64",
                   "complex128")


def _offset_view(torch, base, dim, s0, s1, off):
    """``base`` narrowed to ``[s0, s1)`` along ``dim``, placed ``off``
    elements into a larger buffer (its storage offset)."""
    buf = torch.empty(base.numel() + off, dtype=base.dtype,
                      device=base.device)
    whole = buf[off:].view(base.shape)
    whole.copy_(base)
    return whole.narrow(dim, s0, s1 - s0)


def k1_chunks(torch, k1, gen):
    """K1 on chunk views against the plain versions, bit for bit: pack and
    permute read a chunk of a block (a strided view), unpack and permute
    write into a chunk of a larger output (a strided view); each at a
    storage offset of 0, of 16 bytes and of one element (so 16-byte
    aligned and not), on both sides; the bytes of the output outside the
    view must stay.  Returns ``(comparisons, launches by instance)``."""
    by0 = dict(k1.launches_by_instance)
    n = 0

    def check(tag, got, want, what):
        if not same_bits(torch, got, want):
            raise AssertionError(f"K1 chunk {tag} {what} differs")

    for name in K1_CHUNK_DTYPES:
        dtype = getattr(torch, name)
        for shape, axes, cdim in K1_CHUNKS:
            base = random_tensor(torch, shape, dtype, gen)
            E = base.element_size()
            ext = shape[cdim]
            step = -(-ext // 3)
            for s0 in range(0, ext, step):
                s1 = min(s0 + step, ext)
                for off in (0, max(1, 16 // E), 1):
                    v = _offset_view(torch, base, cdim, s0, s1, off)
                    what = (f"{shape} {axes} {name} chunk {cdim}:[{s0},"
                            f"{s1}) offset {off}")
                    for dim, P in ((0, 2), (len(shape) - 1, 3)):
                        tiles = k1.pack(v, axes, dim, P)
                        want = k1.pack_plain(v, axes, dim, P)
                        check("pack", tiles, want, what)
                        n_a = want.shape[0] * want.shape[dim + 1] - (P - 1)
                        res = k1.unpack_plain(want, tuple(range(len(shape))),
                                              dim, n_a)
                        big = list(res.shape)
                        big[cdim] += 5
                        dst = _offset_view(torch, random_tensor(
                            torch, tuple(big), dtype, gen), cdim, 2,
                            2 + res.shape[cdim], off)
                        full = dst.as_strided((math.prod(big) + off,), (1,),
                                              0)
                        before = full.clone()
                        k1.unpack(tiles, tuple(range(len(shape))), dim, n_a,
                                  out=dst)
                        check("unpack", dst, res, what)
                        before.as_strided(dst.shape, dst.stride(),
                                          dst.storage_offset()).copy_(res)
                        check("unpack (bytes outside the view)", full,
                              before, what)
                        n += 2
                    # permute from the chunk into a chunk of a larger output
                    want = k1.permute_plain(v, axes)
                    big = list(want.shape)
                    big[0] += 3
                    dst = _offset_view(torch, torch.zeros(
                        big, dtype=dtype, device="cuda"), 0, 1,
                        1 + want.shape[0], off)
                    check("permute", k1.permute(v, axes, out=dst), want,
                          what)
                    n += 1
    torch.cuda.synchronize()
    return n, {i: k1.launches_by_instance[i] - by0[i] for i in by0}


def k1_beyond_2_31(torch, k1, gen):
    """One narrow launch over more than 2^31 words: 3 x 1024^3 f32
    (1, 2, 3, 0), 12.9 GB in; returns its word count."""
    shape, axes = (3, 1024, 1024, 1024), (1, 2, 3, 0)
    x = torch.empty(shape, dtype=torch.int32, device="cuda")
    for c in range(3):  # bit patterns, NaN payloads among them
        x[c].random_(generator=gen)
    x = x.view(torch.float32)
    by0 = dict(k1.launches_by_instance)
    got = k1.permute(x, axes)
    torch.cuda.synchronize()
    if {i: k1.launches_by_instance[i] - by0[i] for i in by0} != {
            "copy": 0, "narrow": 1, "tiled": 0}:
        raise AssertionError("the 2^31-word launch did not take narrow")
    want = k1.permute_plain(x, axes)
    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        raise AssertionError("K1 over 2^31 words differs from plain")
    del got, want, x
    torch.cuda.empty_cache()
    return math.prod(shape)


def phase_kernel(torch, k1):
    """K1 against its plain versions, bit for bit: the NS step's shapes
    and two hop classes, ragged shapes in six dtypes with pack/unpack at
    P = 1, 2, 4, every instance at its edges (k1_edges) and one launch
    over more than 2^31 words.  Its timings run after phase 9
    (k1_timing), over the classes phases 3, 5 and 7 record."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    by0 = dict(k1.launches_by_instance)
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
                checks += _k1_same(torch, k1, "ragged", x, axes)
                for dim in range(nd):
                    for P in (1, 2, 4):
                        checks += _k1_same(torch, k1, "ragged", x, axes, dim,
                                           P)
    torch.cuda.empty_cache()
    edges, edge_by = k1_edges(torch, k1, gen)
    chunks, chunk_by = k1_chunks(torch, k1, gen)
    words = k1_beyond_2_31(torch, k1, gen)
    by = {i: k1.launches_by_instance[i] - by0[i] for i in by0}
    if min(by.values()) <= 0:
        raise AssertionError(f"K1 checks launched by instance {by}")
    log(f"[k1] bit-identical to the plain versions on the card: {checks} "
        f"cases (the NS step's {len(MAIN_PATH)} shapes, {len(HOPS)} hop "
        f"classes; f32 f64 c64 c128 bf16 i32 ragged; pack/unpack P=1,2,4), "
        f"{edges} edge cases (short dims C={list(K1_EDGE_C)}, "
        f"{'/'.join(K1_EDGE_DTYPES)}, inputs off 16 bytes; launches by "
        f"instance {edge_by}), {chunks} chunk cases (Pipelined chunks of "
        f"{len(K1_CHUNKS)} blocks in {'/'.join(K1_CHUNK_DTYPES)}, ragged "
        f"tails, an extra-dim chunk, strided sources and destinations at "
        f"offsets 0, 16 bytes and one element; launches by instance "
        f"{chunk_by}), one narrow launch over {words} words (> 2^31); "
        f"launches by instance {by}")
    return dict(checks=checks + edges + chunks + 1, launches_by_instance=by)


def _k1_cls(cls):
    """``(kind, shape, axes, dim, arg, dtype, layout)`` of a recorded K1
    class (``permute._launch``'s key: a layout only for views)."""
    kind, shape, axes = cls[:3]
    rest = list(cls[3:])
    layout = rest.pop() if isinstance(rest[-1], tuple) else None
    dtype = rest.pop()
    dim, arg = rest if rest else (None, None)
    return kind, shape, axes, dim, arg, dtype, layout


def _k1_view(torch, shape, strides, off, dtype, gen=None):
    """A view of ``shape`` and ``strides`` at storage offset ``off`` in a
    fresh buffer (random when ``gen`` is given)."""
    span = sum((n - 1) * st for n, st in zip(shape, strides)) + 1
    buf = (random_tensor(torch, (off + span,), dtype, gen) if gen is not None
           else torch.empty(off + span, dtype=dtype, device="cuda"))
    return buf.as_strided(tuple(shape), tuple(strides), off)


def _k1_out(torch, k1, cls):
    """A fresh output for a recorded class: ``None`` (the wrapper
    allocates) or a view with the recorded strides and offset."""
    _, _, _, _, _, dtype, layout = _k1_cls(cls)
    if layout is None or layout[2] is None:
        return None
    return _k1_view(torch, _k1_desc(k1, cls)[0], layout[2], layout[3],
                    getattr(torch, dtype))


def _k1_class_call(torch, k1, cls, gen):
    """The input and output of a recorded K1 class and its kernel, plain and
    library calls (library: one PyTorch call computing the same function,
    where there is one: a permute, or a pack/unpack with nothing to pad)."""
    kind, shape, axes, dim, arg, dname, layout = _k1_cls(cls)
    dtype = getattr(torch, dname)
    x = (random_tensor(torch, shape, dtype, gen) if layout is None else
         _k1_view(torch, shape, layout[0], layout[1], dtype, gen))
    out = _k1_out(torch, k1, cls)

    def into(y):
        return y.contiguous() if out is None else out.copy_(y)

    if kind == "permute":
        return x, out, (lambda: k1.permute(x, axes, out=out),
                        lambda: k1._plain_into(k1.permute_plain(x, axes),
                                               out),
                        lambda: into(x.permute(axes)))
    if kind == "pack":
        lib = None
        if arg == 1:
            def lib():
                return into(x.permute(axes).unsqueeze(0))
        return x, out, (lambda: k1.pack(x, axes, dim, arg, out=out),
                        lambda: k1._plain_into(
                            k1.pack_plain(x, axes, dim, arg), out), lib)
    lib = None
    if shape[0] == 1 and arg == shape[dim + 1]:
        def lib():
            return into(x[0].permute(axes))
    return x, out, (lambda: k1.unpack(x, axes, dim, arg, out=out),
                    lambda: k1._plain_into(
                        k1.unpack_plain(x, axes, dim, arg), out), lib)


def _k1_desc(k1, cls):
    kind, shape, axes, dim, arg, _, layout = _k1_cls(cls)
    ist, ost = (None, None) if layout is None else (layout[0], layout[2])
    if kind == "permute":
        return k1._describe_permute(shape, axes, ist, ost)
    if kind == "pack":
        return k1._describe_pack(shape, axes, dim, arg, ist, ost)
    return k1._describe_unpack(shape, axes, dim, arg, ist, ost)


def k1_timing(torch, k1, bw, recorded, extra):
    """Kernel (``run_plan`` into the checked output), call (the wrapper,
    which allocates its output each call), plain, copy (``dst.copy_`` of
    the input's bytes) and library times (CUDA-event means of 10
    launches, 3 for a class only phase 5i launched, after a warm-up),
    bound (input and output bytes over the card's memory rate), instance
    and error of every K1 class the runs in ``recorded`` launched ({run:
    {class: count}}), and of the ``extra`` (label, shape, axes, dtype)
    permutes; for a narrow class also ``ring_ms``, the same copy walked by
    the tiled instance.  A class of views (a Pipelined hop's chunks, a
    fused hop's slices) is timed on views with its strides and offsets;
    returns {class: row}.  At most three tensors of a class's size are
    held at once (phase 5i's 16 GiB c128 cycle class needs 48 GiB)."""
    gc.collect()                 # tensors held in the phases' cycles
    torch.backends.cuda.cufft_plan_cache.clear()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    log(f"[k1] timings start with {_gib(free):.2f} of {_gib(total):.2f} "
        f"GiB free, {_gib(torch.cuda.memory_reserved()):.2f} reserved by "
        f"PyTorch")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    classes = {}
    for run, rec in recorded.items():
        for cls, n in rec.items():
            classes.setdefault(cls, {})[run] = n
    for _, shape, axes, dtype in extra:
        classes.setdefault(("permute", tuple(shape), tuple(axes), dtype), {})
    rows = {}
    for cls, runs in classes.items():
        kind, shape, axes, dim, arg, dname, layout = _k1_cls(cls)
        x, out, (kernel, plain, lib) = _k1_class_call(torch, k1, cls, gen)
        want = plain()
        if out is not None:
            want = want.clone()
            out.zero_()           # the plain version wrote there first
        got = kernel()
        if not same_bits(torch, got, want):
            raise AssertionError(f"K1 class {cls} differs from plain")
        err = (max_abs_err(torch, got, want)
               if got.is_floating_point() or got.is_complex() else 0.0)
        want = None
        nbytes = (x.numel() * x.element_size()
                  + got.numel() * got.element_size())
        plan = k1.plan_copy(_k1_desc(k1, cls), x.element_size(),
                            k1._address_align(x, got))
        by0 = dict(k1.launches_by_instance)
        it = 3 if set(runs) <= set(AUTODIFF_PATHS) else 10
        r = dict(kind=kind, shape=list(shape), axes=list(axes), dtype=dname,
                 layout=layout, instance=plan.instance, launches=runs,
                 ms=cuda_ms(torch, lambda: k1.run_plan(plan, x, got), it))
        dst = torch.empty_like(x)
        r.update(copy_ms=cuda_ms(torch, lambda: dst.copy_(x), it))
        dst = None
        r.update(call_ms=cuda_ms(torch, kernel, it),
                 plain_ms=cuda_ms(torch, plain, it),
                 library_ms=cuda_ms(torch, lib, it) if lib else None,
                 bound_ms=nbytes / bw * 1e3, bound_by="bytes",
                 max_abs_err=err, bytes=nbytes)
        if kind != "permute":
            r.update(dim=dim, P_or_n=arg)
        by = {i: k1.launches_by_instance[i] - by0[i] for i in by0}
        if by != {i: 2 * (it + 1) * (i == plan.instance) for i in by}:
            raise AssertionError(f"K1 class {cls} launched {by}")
        r["GBps"] = nbytes / r["ms"] / 1e6
        r["of_bound"] = r["bound_ms"] / r["ms"]
        if plan.instance == "narrow":
            # the walk narrow replaced: the tiled instance's ring of flat
            # tiles, on the same inputs (not counted in any path)
            ring = _ring_plan(k1, plan)
            again = torch.empty_like(got) if out is None else _k1_out(
                torch, k1, cls)
            k1.run_plan(ring, x, again)
            if not same_bits(torch, again, got):
                raise AssertionError(f"K1 class {cls}: ring walk differs")
            r["ring_ms"] = cuda_ms(torch, lambda: k1.run_plan(ring, x, again),
                                   it)
            del again
        rows[cls] = r
        log(f"[k1] {kind} {shape} {axes} {dname}: " + json.dumps(
            {k: (round(v, 4) if isinstance(v, float) else v)
             for k, v in r.items() if k not in ("kind", "shape", "axes",
                                                "dtype")}))
        # the closures hold this class's tensors too
        x = out = got = kernel = plain = lib = None
        torch.cuda.empty_cache()
    return rows


def _ring_plan(k1, plan):
    """A narrow plan's copy as the tiled instance walks it: flat tiles of
    about 16 KB through the shared-memory ring."""
    import dataclasses

    E = plan.elem_bytes
    if plan.flat_in:
        TI, TO = plan.TI, k1._run(plan.ext[plan.dO], plan.TI, E)
    else:
        TI, TO = k1._run(plan.ext[plan.dI], plan.TO, E), plan.TO
    return dataclasses.replace(plan, instance="tiled", TI=TI, TO=TO,
                               lane_rows=TI if plan.flat_in else 1,
                               seg_shift=7)


def _k1_per_run(timed, rec, runs=1):
    """Kernel, call, plain, library and bound ms of the K1 launches ``rec``
    ({class: count}) made, per run over ``runs``; ``timed`` maps each class
    to its k1_timing row (library None where a class has none)."""
    out = {}
    for key in ("ms", "call_ms", "plain_ms", "library_ms", "bound_ms"):
        vals = [n * timed[cls][key] if timed[cls][key] is not None else None
                for cls, n in rec.items()]
        out[key] = None if None in vals else sum(vals) / runs
    return out


def _reset_k1(k1, tr=None):
    k1.launches = 0
    k1.bytes_moved = 0
    for inst in k1.launches_by_instance:
        k1.launches_by_instance[inst] = 0
    if tr is not None:
        for table in (tr.exchange_calls, tr.exchange_bytes):
            for op in table:
                table[op] = 0


# phase 3's transpose methods, by the path name each run counts under
def cycle_methods(pat):
    return {"cycle": pat.AllToAll(), "cycle_ring": pat.Ring(),
            "cycle_pipelined": pat.Pipelined(4),
            "cycle_pipelined_ring": pat.Pipelined(3, pat.Ring())}


def phase_cycle(torch, pat, k1, tr, n=1024):
    """The 1024^3 f32 x->y->z->y->x cycle on (1, 1) under each method:
    every hop bit-identical to the AllToAll hop, the round trip
    bit-identical, one timed cycle (ms, GB/s, K1 launches by instance,
    K1 bytes, exchange calls) and one profile each.  The K1 bytes of every
    method must equal AllToAll's: a Pipelined hop packs and unpacks its
    chunks in place."""
    topo = pat.Topology((1, 1))
    shape = (n, n, n)
    px = pat.Pencil(topo, shape, (1, 2), permutation=pat.Permutation(1, 2, 0))
    py = pat.Pencil(topo, shape, (0, 2), permutation=pat.Permutation(0, 2, 1))
    pz = pat.Pencil(topo, shape, (0, 1))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    x = pat.PencilArray(px, torch.randn(shape, generator=gen, device="cuda"))
    chain = [py, pz, py, px]
    pens = [px] + chain
    nbytes = sum(tr.hop_operand_bytes(a, b, (), torch.float32)
                 for a, b in zip(pens, pens[1:]))
    ref, v = [], x
    for pen in chain:                       # AllToAll's hops (a warm-up)
        v = pat.transpose(v, pen)
        ref.append(v.data)
    del v
    out = {}
    for run, method in cycle_methods(pat).items():
        def cycle():
            v = x
            for pen in chain:
                v = pat.transpose(v, pen, method=method)
            return v

        v = x                                # warm-up, hop by hop
        for i, pen in enumerate(chain):
            v = pat.transpose(v, pen, method=method)
            if not same_bits(torch, v.data, ref[i]):
                raise AssertionError(f"{run}: hop {i + 1} differs from the "
                                     f"AllToAll hop")
        del v
        torch.cuda.synchronize()
        _reset_k1(k1, tr)
        k1.recorded = {}
        t0 = time.perf_counter()
        back = cycle()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        r = dict(method=repr(method), ms=secs * 1e3, GBps=nbytes / secs / 1e9,
                 launches=k1.launches,
                 launches_by_instance=dict(k1.launches_by_instance),
                 k1_bytes=k1.bytes_moved,
                 exchange_calls=dict(tr.exchange_calls),
                 recorded=k1.recorded)
        k1.recorded = None
        if not same_bits(torch, back.data, x.data):
            raise AssertionError(f"{run}: x->y->z->y->x round trip is not "
                                 f"bit-identical")
        del back
        wire = sum(sum(c["bytes"] for c in pat.transpose_cost(
            a, b, (), torch.float32, method).values())
            for a, b in zip(pens, pens[1:]))
        log(f"[cycle] {run} {method!r}: {n}^3 f32 (1,1) x->y->z->y->x, "
            f"every hop bit-identical to AllToAll's, round trip "
            f"bit-identical; {r['ms']:.2f} ms, {r['GBps']:.1f} GB/s over "
            f"{nbytes} operand bytes (transpose_cost wire bytes {wire} on a "
            f"size-1 axis); K1 launches {r['launches']}, by instance "
            f"{r['launches_by_instance']}, K1 bytes {r['k1_bytes']}; "
            f"exchange calls {r['exchange_calls']}")
        if r["launches"] <= 0:
            raise AssertionError(f"{run} launched K1 no time")
        r["profile"] = profile(torch, cycle, f"{n}^3 f32 cycle (4 hops) "
                               f"{run}")
        out[run] = r
    k1_bytes = {run: r["k1_bytes"] for run, r in out.items()}
    log(f"[cycle] K1 bytes of the cycle by method: {k1_bytes}")
    if len(set(k1_bytes.values())) != 1:
        raise AssertionError(f"K1 bytes differ between methods: {k1_bytes}")
    del x, ref
    torch.cuda.empty_cache()
    return out


# -- phase 3w: reduced-precision wire formats, Gspmd and reshard ------------

WIRE_EDGES = [float("nan"), -float("nan"), float("inf"), -float("inf"),
              -0.0, 0.0, 1e-40, -1e-40, 1e-45, 5e-39, 449.0, 1e5, 7e4,
              3.4028234663852886e38, -3.4028234663852886e38, 1e-300, 2e-310,
              -3e-320, 1e-37, 3e-36, 1e300]


def _wire_edge_array(np, shape, dtype, rng):
    """Random values over 16 decades with the edge values scattered in,
    and four special rows along the last axis: all zero, all subnormal in
    f32, a window whose f32 scale is subnormal, all subnormal in f64."""
    n = int(np.prod(shape))
    x = rng.standard_normal(n) * np.exp(rng.uniform(-18, 18, n))
    idx = rng.choice(n, size=min(n, 200), replace=False)
    edges = np.array(WIRE_EDGES)
    x[idx] = edges[rng.integers(0, len(edges), len(idx))]
    x = x.reshape(shape)
    rows = x.reshape(-1, shape[-1])
    rows[0] = 0.0
    rows[1] = 1e-39
    rows[2] = rng.standard_normal(shape[-1]) * 1e-37
    rows[3] = rng.standard_normal(shape[-1]) * 1e-310
    with np.errstate(over="ignore"):
        if np.issubdtype(dtype, np.complexfloating):
            out = np.empty(shape, dtype)
            out.real, out.imag = x, np.roll(x, 1)
            return out
        return x.astype(dtype)


def wire_bits_check(torch, wire):
    """``wire.pack`` on the card against the port on the CPU, byte for
    byte, and ``unpack`` bit for bit: every wire dtype on f32, f64, c64
    and c128 payloads, ragged tile tails, NaN of both signs, infinities,
    signed zeros, subnormals, values above the fp8 range, all-zero
    windows, windows whose scale is subnormal.  The card keeps IEEE
    subnormals, so the CPU side runs without XLA:CPU's flush
    (``ftz=False``)."""
    import numpy as np

    rng = np.random.default_rng(SEED + 30)
    n = 0
    for shape, axes in (((3, 5, 600), (0, 1)), ((4, 300, 2), (0, 2)),
                        ((7, 2, 513), (1, 0)), ((2, 3, 256), (0, 1))):
        for dtype in (np.float32, np.float64, np.complex64, np.complex128):
            host = torch.from_numpy(_wire_edge_array(np, shape, dtype, rng))
            dev = host.cuda()
            for w in wire.WIRE_DTYPES:
                want = wire.pack(host, w, axes=axes, ftz=False)
                got = wire.pack(dev, w, axes=axes)
                if not same_bits(torch, got.cpu(), want):
                    raise AssertionError(f"wire.pack {w} {shape} {dtype}: "
                                         f"the card's bytes differ")
                back = wire.unpack(want, host.dtype, w, axes=axes,
                                   orig_shape=shape, ftz=False)
                got_back = wire.unpack(want.cuda(), host.dtype, w,
                                       axes=axes, orig_shape=shape)
                if not same_bits(torch, got_back.cpu(), back):
                    a = got_back.cpu().numpy().view(np.uint8)
                    b = back.numpy().view(np.uint8)
                    bad = np.argwhere(a != b)[:4].tolist()
                    raise AssertionError(
                        f"wire.unpack {w} {shape} {dtype}: the card's bits "
                        f"differ at byte indices {bad}: "
                        f"{[a[tuple(i)] for i in bad]} against "
                        f"{[b[tuple(i)] for i in bad]}")
                n += 1
    log(f"[wire] pack and unpack on the card bit-identical to the CPU "
        f"port: {n} cases (4 wires x f32/f64/c64/c128 x 4 geometries, "
        f"ragged tails, NaN/inf/-0/subnormal/above-range edges)")
    return n


def ftz_cost(torch, wire, n=1024):
    """What XLA:CPU's flush-to-zero (on only for CPU tensors) would cost
    the card: ``pack_axis`` + ``unpack_axis`` of an n^3 f32 operand with
    ``ftz=True`` against the card's default, median of 3 (CUDA events)
    after a warm-up, alternating, on e4m3 (on f32 payloads only the fp8
    path flushes)."""
    x = torch.randn((n, n, n), generator=torch.Generator(
        device="cuda").manual_seed(SEED + 32), device="cuda")
    out = {}
    for ftz in (False, True, False, True):
        def rt():
            y = wire.pack_axis(x, "fp8_e4m3", 2, ftz=ftz)
            return wire.unpack_axis(y, x.dtype, "fp8_e4m3", 2, n, ftz=ftz)
        rt()
        ms = []
        for _ in range(3):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            rt()
            b.record()
            torch.cuda.synchronize()
            ms.append(a.elapsed_time(b))
        out.setdefault(f"fp8_e4m3_ftz={ftz}", []).append(_median(ms))
    del x
    torch.cuda.empty_cache()
    log(f"[wire] {n}^3 f32 pack+unpack ms with and without the flush "
        f"(alternating runs): " + json.dumps(out))
    return out


def wire_methods(pat):
    """Phase 3w's wired cycle methods, by the path name each run counts
    under."""
    return {"cycle_wire_bf16": pat.AllToAll(wire_dtype="bf16"),
            "cycle_wire_f16": pat.AllToAll(wire_dtype="f16"),
            "cycle_wire_fp8_e4m3": pat.AllToAll(wire_dtype="fp8_e4m3"),
            "cycle_wire_fp8_e5m2": pat.AllToAll(wire_dtype="fp8_e5m2"),
            "cycle_wire_ring_bf16": pat.Ring(wire_dtype="bf16"),
            "cycle_wire_pipelined4_fp8_e4m3": pat.Pipelined(
                4, pat.AllToAll(wire_dtype="fp8_e4m3"))}


def _quantized_reference(pat, tr, wire, v, pin, pout, method):
    """The unwired hop applied to the plain logical-order round trip
    ``unpack(pack(x))`` of the hop's operand (per chunk under
    ``Pipelined``, where each chunk packs its own windows)."""
    from pencilarrays_tpu_torch.parallel.arrays import _fwd_axes, _inv_axes

    R = tr.assert_compatible(pin, pout)
    a, b = pin.decomposition[R], pout.decomposition[R]
    w = tr._method_wire(method)
    logical = v.data.permute(_inv_axes(pin, 0))   # P = 1: no padding
    bounds = [(0, logical.shape[0])]
    c = None
    if isinstance(method, pat.Pipelined):
        c = tr._pipeline_chunk_axis(tuple(logical.shape), a, b)
        bounds = tr._chunk_bounds(logical.shape[c], method.chunks)
    q = logical.new_empty(logical.shape)
    for s0, s1 in bounds:
        part = logical if c is None else logical.narrow(c, s0, s1 - s0)
        dst = q if c is None else q.narrow(c, s0, s1 - s0)
        dst.copy_(wire.unpack(wire.pack(part, w, axes=(a, b)), part.dtype,
                              w, axes=(a, b), orig_shape=tuple(part.shape)))
    mem = q.permute(_fwd_axes(pin, 0)).contiguous()
    del q
    return pat.transpose(pat.PencilArray(pin, mem), pout).data


def _moved_bytes(pat, tr, wire, pens, method):
    """What the hops of ``pens`` hand their exchange calls on a size-1
    axis, where ``transpose_cost`` prices nothing: the packed operand per
    chunk under AllToAll (the cost model's operand accounting), nothing
    under Ring (a ring of one makes no round)."""
    base = method.base if isinstance(method, pat.Pipelined) else method
    if isinstance(base, pat.Ring):
        return 0
    total = 0
    for pin, pout in zip(pens, pens[1:]):
        R = tr.assert_compatible(pin, pout)
        a, b = pin.decomposition[R], pout.decomposition[R]
        shape = tr._exchange_operand_extents(pin, pout, R)
        bounds, c = [None], None
        if isinstance(method, pat.Pipelined):
            c = tr._pipeline_chunk_axis(shape, a, b)
            bounds = tr._chunk_bounds(shape[c], method.chunks)
        for bd in bounds:
            s = shape if bd is None else (shape[:c] + (bd[1] - bd[0],)
                                          + shape[c + 1:])
            total += wire.wire_bytes("float32", base.wire_dtype, s,
                                     axes=(a, b))
    return total


def wired_cycle_check(torch, pat, k1, tr, wire, plain, n=1024, small=64):
    """The n^3 f32 x->y->z->y->x cycle on (1, 1) under each wired method:
    each hop bit-identical to the unwired hop on ``unpack(pack(x))`` of
    its operand, the K1 launches of the unwired cycle (phase 3's run of
    the same method without a wire, in ``plain``) and its K1 bytes (half
    of them on a 16-bit wire, whose casts come before K1's pack and after
    its unpack), the
    exchange bytes the cost model's
    operand accounting gives, the round trip's error norm within the
    wire's unit roundoff per hop; cycle ms, peak memory and a profile
    (K1, exchange, cast).  At ``small``^3 the card's cycle equals the CPU
    port's bits."""
    topo = pat.Topology((1, 1))
    shape = (n, n, n)
    px = pat.Pencil(topo, shape, (1, 2), permutation=pat.Permutation(1, 2, 0))
    py = pat.Pencil(topo, shape, (0, 2), permutation=pat.Permutation(0, 2, 1))
    pz = pat.Pencil(topo, shape, (0, 1))
    pens = [px, py, pz, py, px]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    x = pat.PencilArray(px, torch.randn(shape, generator=gen, device="cuda"))
    xnorm = float(torch.linalg.vector_norm(x.data))
    xmax = float(x.data.abs().max())
    out = {}
    for run, method in wire_methods(pat).items():
        w = tr._method_wire(method)
        v = x                                   # warm-up, hop by hop
        for i, pout in enumerate(pens[1:]):
            ref = _quantized_reference(pat, tr, wire, v, pens[i], pout,
                                       method)
            v = pat.transpose(v, pout, method=method)
            if not same_bits(torch, v.data, ref):
                raise AssertionError(f"{run}: hop {i + 1} differs from the "
                                     f"unwired hop on unpack(pack(x))")
            del ref
        del v
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

        def cycle():
            v = x
            for pen in pens[1:]:
                v = pat.transpose(v, pen, method=method)
            return v

        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        back, counts = _run_counted(torch, k1, tr, cycle)
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        moved = dict(tr.exchange_bytes)
        want = (_moved_bytes(pat, tr, wire, pens, method)
                if topo.connected else 0)
        if sum(moved.values()) != want:
            raise AssertionError(f"{run}: exchange bytes {moved}, the cost "
                                 f"model's operands {want}")
        same = plain[{"AllToAll": "cycle", "Ring": "cycle_ring",
                      "Pipelined": "cycle_pipelined"}[type(method).__name__]]
        # a 16-bit wire casts before K1's pack and widens after its
        # unpack, so K1 moves the 2-byte words: half the unwired bytes
        k1_bytes = same["k1_bytes"] // (2 if w in ("bf16", "f16") else 1)
        if (counts["launches"], counts["k1_bytes"]) != (
                same["launches"], k1_bytes):
            raise AssertionError(
                f"{run}: K1 launches/bytes {counts['launches']}/"
                f"{counts['k1_bytes']}, want the unwired cycle's "
                f"{same['launches']}/{k1_bytes}")
        # each hop rounds every element once: by at most the format's
        # unit roundoff of it, or below the normal range by half the
        # smallest subnormal step (of the window's scale, max-abs over
        # the format's max, on fp8)
        fi = torch.finfo(wire._torch_wire(w))
        win = xmax / fi.max if w in wire.FP8_WIRE_DTYPES else 1.0
        bound = (len(pens) - 1) * (
            fi.eps / 2 + fi.smallest_normal * fi.eps / 2 * win
            * math.sqrt(x.data.numel()) / xnorm) * (1 + 2.0 ** -8)
        err = float(torch.linalg.vector_norm(back.data - x.data)) / xnorm
        if not err <= bound:
            raise AssertionError(f"{run}: round-trip error norm {err} of "
                                 f"the input's over {bound}")
        rel = float((back.data - x.data).abs().max() / x.data.abs().max())
        del back
        times = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cycle()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        r = dict(method=repr(method), wire=w, ms=_median(
            [secs * 1e3] + times), ms_runs=[secs * 1e3] + times,
            peak_above_input=peak, exchange_bytes=moved,
            rel_l2_err=err, rel_l2_bound=bound,
            max_abs_err_of_max=rel, **counts)
        log(f"[wire] {run} {method!r}: {n}^3 f32 (1,1) x->y->z->y->x every "
            f"hop bit-identical to the unwired hop on unpack(pack(x)); "
            + json.dumps({k: v for k, v in r.items() if k not in (
                "recorded", "method")}))
        r["profile"] = profile(torch, cycle, f"{n}^3 f32 cycle {run}",
                               extra_groups=(("cast", ("elementwise_kernel",
                                                       "reduce_kernel")),))
        out[run] = r
        torch.cuda.empty_cache()
    del x
    torch.cuda.empty_cache()
    # small: the card's wired cycle against the CPU port's, bit for bit
    cpu = pat.Topology.unconnected((1, 1), "cpu")
    shape = (small, small, small)
    u = torch.randn(shape, generator=torch.Generator().manual_seed(SEED + 31))
    for run, method in wire_methods(pat).items():
        res = []
        for t in (topo, cpu):
            chain = [pat.Pencil(t, shape, p.decomposition,
                                permutation=p.permutation) for p in pens]
            v = pat.PencilArray(chain[0], u.to(t.device))
            for pen in chain[1:]:
                v = pat.transpose(v, pen, method=method)
            res.append(v.data.cpu())
        if not same_bits(torch, res[0], res[1]):
            raise AssertionError(f"{run}: the card's {small}^3 cycle "
                                 f"differs from the CPU port's")
    log(f"[wire] {small}^3 wired cycles on the card bit-identical to the "
        f"CPU port's, every method")
    return out


def reshard_check(torch, pat, k1, tr, routing, n=1024):
    """``reshard`` of an n^3 f32 field between pencils that differ in both
    slots and in memory order: the default (the planner's verdict on one
    card), a forced ``AllToAll()`` route, a wired route, a forced
    ``Pipelined(4)`` route (the chunked hops an ``hbm_limit`` synthesizes
    on several ranks; on one card its hops cross no rank and run as one
    permute), an ``hbm_limit`` at the route's modeled peak
    (``routed:hbm``) and one byte under it (``HbmBoundError``), and
    ``ManyPencilArray.reshard_to``; every data-movement path bit-identical
    to ``Gspmd()``'s; ms (median of 3 warm runs), K1 launches and the peak
    above the input (a run of its own) beside the route's
    ``peak_hbm_bytes``, which the ``hbm_limit`` run must keep."""
    from pencilarrays_tpu_torch.analysis import HbmBoundError

    topo = pat.Topology((1, 1))
    shape = (n, n, n)
    px = pat.Pencil(topo, shape, (1, 2), permutation=pat.Permutation(1, 2, 0))
    py = pat.Pencil(topo, shape, (0, 2), permutation=pat.Permutation(0, 2, 1))
    pd = pat.Pencil(topo, shape, (2, 0), permutation=pat.Permutation(2, 0, 1))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    field = torch.randn(shape, generator=gen, device="cuda")
    ref = pat.reshard(pat.PencilArray(px, field), pd,
                      method=pat.Gspmd()).data
    peak_model = routing.plan_reshard_route(
        px, pd, (), torch.float32, method=pat.AllToAll()).peak_hbm_bytes
    runs = {
        "reshard_default": dict(),
        "reshard_gspmd": dict(method=pat.Gspmd()),
        "reshard_alltoall": dict(method=pat.AllToAll()),
        "reshard_wire_bf16": dict(method=pat.AllToAll(wire_dtype="bf16")),
        "reshard_wire_fp8": dict(method=pat.AllToAll(
            wire_dtype="fp8_e4m3")),
        "reshard_pipelined4": dict(method=pat.Pipelined(4)),
        "reshard_hbm": dict(hbm_limit=peak_model),
        "reshard_to": None,
    }
    out = {}
    for run, kwargs in runs.items():
        if kwargs is None:
            def fn(box):
                A = pat.ManyPencilArray(px, py, pd,
                                        first=pat.PencilArray(px, box.pop()))
                return A.reshard_to(2)
            route = routing.plan_reshard_route(px, pd, (), torch.float32,
                                               donate=True)
        else:
            def fn(box, kwargs=kwargs):
                return pat.reshard(pat.PencilArray(px, box.pop()), pd,
                                   **kwargs)
            route = (None if isinstance(kwargs.get("method"), pat.Gspmd)
                     else routing.plan_reshard_route(
                         px, pd, (), torch.float32,
                         **{k: v for k, v in kwargs.items()
                            if k in ("method", "hbm_limit")}))
        fn([field.clone()])                         # warm-up
        times = []
        for _ in range(3):
            box = [field.clone()]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(box)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        box = [field.clone()]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        res, counts = _run_counted(torch, k1, tr, lambda: fn(box))
        peak = torch.cuda.max_memory_allocated() - base
        wired = kwargs is not None and tr._method_wire(
            kwargs.get("method")) is not None
        if not wired and not same_bits(torch, res.data, ref):
            raise AssertionError(f"{run}: differs from the Gspmd reshard")
        if wired:
            # two hops, each within half a step of its format: bf16 2^-8
            # of the element, e4m3 2^-4 of its window's max plus the
            # window's subnormal step (2^-9 of a scale that maps the max
            # to 448)
            fp8 = tr._method_wire(kwargs["method"]).startswith("fp8")
            tol = (2 * (2.0 ** -4 + 2.0 ** -9 / 448) if fp8
                   else 2 * 2.0 ** -8)
            err = float((res.data - ref).abs().max() / ref.abs().max())
            if not err <= tol:
                raise AssertionError(f"{run}: error {err} over two steps of "
                                     f"its wire ({tol})")
        del res
        r = dict(ms=_median(times), ms_runs=times, peak_above_input=peak,
                 verdict=None if route is None else route.verdict,
                 hops=None if route is None else [
                     [list(h.dest.decomposition), tr._method_label(h.method)]
                     for h in route.hops],
                 peak_hbm_bytes=None if route is None else
                 route.peak_hbm_bytes, **counts)
        log(f"[reshard] {run}: " + json.dumps(
            {k: v for k, v in r.items() if k != "recorded"}))
        if counts["launches"] <= 0:
            raise AssertionError(f"{run} launched K1 no time")
        out[run] = r
        torch.cuda.empty_cache()
    # the model counts the resident (not donated) input; the limit the
    # run was given is the route's own modeled peak
    held = field.numel() * field.element_size()
    if out["reshard_hbm"]["peak_above_input"] > peak_model - held:
        raise AssertionError(
            f"reshard_hbm: peak {out['reshard_hbm']['peak_above_input']} "
            f"above the input, over hbm_limit {peak_model} less the "
            f"input's {held}")
    # a route's wired hops that cross no rank (one card) run as one K1
    # permute and each hop's wire round trip in place, slab by slab: the
    # wired routes keep their modeled peaks (one operand and one packed
    # chunk)
    bf16 = out["reshard_wire_bf16"]
    if bf16["peak_above_input"] > bf16["peak_hbm_bytes"] - held:
        raise AssertionError(
            f"reshard_wire_bf16: peak {bf16['peak_above_input']} above the "
            f"input, over its modeled peak {bf16['peak_hbm_bytes']} less "
            f"the input's {held}")
    fp8 = out["reshard_wire_fp8"]
    if fp8["peak_above_input"] > fp8["peak_hbm_bytes"] - held:
        raise AssertionError(
            f"reshard_wire_fp8: peak {fp8['peak_above_input']} above the "
            f"input, over its modeled peak {fp8['peak_hbm_bytes']} less "
            f"the input's {held}")
    # the chunked route's hops cross no rank on one card (size-1 axes), so
    # execute_route runs them as one K1 permute, as XLA compiles the JAX
    # package's chain: the route keeps its modeled peak (one operand and
    # one chunk)
    pipe = out["reshard_pipelined4"]
    if pipe["peak_above_input"] > pipe["peak_hbm_bytes"] - held:
        raise AssertionError(
            f"reshard_pipelined4: peak {pipe['peak_above_input']} above the "
            f"input, over its modeled peak {pipe['peak_hbm_bytes']} less "
            f"the input's {held}")
    log(f"[reshard] peak above the input against the modeled peak less "
        f"the input: " + json.dumps({run: [r["peak_above_input"], None if
                                          r["peak_hbm_bytes"] is None else
                                          r["peak_hbm_bytes"] - held]
                                    for run, r in out.items()}))
    if out["reshard_default"]["verdict"] != "gspmd":
        raise AssertionError("on one card the planner should keep the "
                             "Gspmd exchange (nothing crosses a link)")
    try:
        pat.reshard(pat.PencilArray(px, field), pd,
                    hbm_limit=peak_model - 1)
    except HbmBoundError as e:
        log(f"[reshard] hbm_limit one byte under the modeled peak: {e}")
    else:
        raise AssertionError("hbm_limit under the peak did not raise")
    del field, ref
    torch.cuda.empty_cache()
    return out


def phase_wire(torch, pat, k1, tr, plain):
    """Phase 3w: the wire formats, Gspmd and reshard on the card."""
    from pencilarrays_tpu_torch.parallel import routing, wire

    t0 = time.perf_counter()
    res = dict(bits_cases=wire_bits_check(torch, wire))
    res["ftz_cost"] = ftz_cost(torch, wire)
    res["cycles"] = wired_cycle_check(torch, pat, k1, tr, wire, plain)
    res["reshard"] = reshard_check(torch, pat, k1, tr, routing)
    log(f"[wire] phase 3w took {time.perf_counter() - t0:.1f} s")
    return res


def phase_fft(torch, dist, pat, k1, tr):
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
    r["strided"] = fft_strided(torch, k1)
    r["fused_hop"] = fused_hop_check(torch, pat, k1, tr)
    r["dct"] = dct_check(torch, dist, pat, k1, tr)
    return r


def _run_counted(torch, k1, tr, fn):
    """``fn()`` with K1's counts and the exchange calls from 0; returns
    its result and ``(launches, by instance, K1 bytes, exchange calls,
    recorded classes)``."""
    torch.cuda.synchronize()
    _reset_k1(k1, tr)
    k1.recorded = {}
    res = fn()
    torch.cuda.synchronize()
    counts = dict(launches=k1.launches,
                  launches_by_instance=dict(k1.launches_by_instance),
                  k1_bytes=k1.bytes_moved,
                  exchange_calls=dict(tr.exchange_calls),
                  recorded=k1.recorded)
    k1.recorded = None
    return res, counts


def fused_hop_check(torch, pat, k1, tr, n=512, K=4):
    """The fused pipelined hop (``ops/fft.py`` ``_fused_hop``) called
    directly on the NS plan's first hop operand — the x-pencil spectrum
    after the r2c stage, (n/2+1) x n x n c64 x 3 components, into the
    y-pencil and its fft along y — on (1, 1), K chunks, forward and
    inverse.  Held to the serialized hop followed by the stage: with no
    transform the data movement bit for bit, with it within 1e-6 of
    max|u_hat| (cuFFT may plan another batch count otherwise).  Times
    both ways (CUDA events, one warm-up, one timed call)."""
    from pencilarrays_tpu_torch.ops import fft as F

    topo = pat.Topology((1, 1))
    plan = pat.PencilFFTPlan(topo, (n, n, n), real=True, dtype=torch.float32,
                             batch=3)
    pens = plan.pencils
    src = pens[0].replace(global_shape=pens[1].size_global())
    tgt = pens[1]
    ops = (("fft", tgt.permutation.apply((0, 1, 2)).index(1), n),)
    spec = F._fuse_spec(("t", src, tgt, plan.dtype_spectral),
                        ("f", tgt, tgt, ops, True), K, pat.AllToAll(),
                        trivial_axis=True)
    _, src, tgt, _, post, ops, pc, base, c, bounds = spec
    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    x = random_tensor(torch, src.padded_size_local(pat.MemoryOrder) + (3,),
                      torch.complex64, gen)
    stage_f = F._stage_op(ops, False, pc, "backward", 3)
    stage_i = F._stage_op(ops, True, pc, "backward", 3)

    def fused(data, inverse, stage_ops=ops):
        return F._fused_hop(data, src, tgt, post, 1, stage_ops, inverse, pc,
                            "backward", base, c, bounds)

    def serial_f():
        return stage_f(tr._hop(x, src, tgt, 1, base))

    # the data movement alone, both ways
    moved = tr._hop(x, src, tgt, 1, base)
    if not same_bits(torch, fused(x, False, ()), moved):
        raise AssertionError("fused hop: data movement differs from the hop")
    if not same_bits(torch, fused(moved, True, ()),
                     tr._hop(moved, tgt, src, 1, base)):
        raise AssertionError("fused inverse hop: data movement differs")
    del moved
    # the path: one forward and one inverse fused hop, counted
    y_ser = serial_f()
    fused(fused(x, False), True)            # warm-up (cuFFT plans)

    def path():
        h = fused(x, False)
        return h, fused(h, True)

    (y, back), counts = _run_counted(torch, k1, tr, path)
    scale = float(y_ser.abs().max())
    err_f = max_abs_err(torch, y, y_ser)
    back_ser = tr._hop(stage_i(y_ser), tgt, src, 1, base)
    err_i = max_abs_err(torch, back, back_ser)
    scale_i = float(back_ser.abs().max())
    if not (err_f <= 1e-6 * scale and err_i <= 1e-6 * scale_i):
        raise AssertionError(f"fused hop off the serialized hop + stage: "
                             f"{err_f} (max {scale}), inverse {err_i} "
                             f"(max {scale_i})")
    r = dict(operand=list(x.shape), chunk_dim=c, bounds=[list(b) for b in
                                                         bounds],
             forward_ms=cuda_ms(torch, lambda: fused(x, False), 1),
             serial_forward_ms=cuda_ms(torch, serial_f, 1),
             inverse_ms=cuda_ms(torch, lambda: fused(y, True), 1),
             serial_inverse_ms=cuda_ms(
                 torch, lambda: tr._hop(stage_i(y_ser), tgt, src, 1, base),
                 1),
             err_forward=err_f, max_abs_forward=scale, err_inverse=err_i,
             max_abs_inverse=scale_i, **counts)
    log("[fft] fused hop " + json.dumps(
        {k: (round(v, 4) if k.endswith("_ms") else v) for k, v in r.items()
         if k != "recorded"}))
    if r["launches"] <= 0:
        raise AssertionError("the fused hop launched K1 no time")
    del x, y, y_ser, back, back_ser
    torch.cuda.empty_cache()
    return r


def dct_check(torch, dist, pat, k1, tr, n=512, small=64, batch=3):
    """A ("dct", "fft", "fft") plan over ``batch`` fields on (1, 1): at n^3
    f32 the round trip within 1e-5 of max|u|, forward and backward times
    (CUDA events, one warm-up, one timed call) and K1's launches (the
    stage's component moves); at small^3 the card against the same port
    on the CPU within 1e-5 of max|u_hat|."""
    kw = dict(transforms=("dct", "fft", "fft"), dtype=torch.float32,
              batch=batch)
    plan = pat.PencilFFTPlan(pat.Topology((1, 1)), (n, n, n), **kw)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 15)
    shape = plan.input_pencil.padded_size_local(pat.MemoryOrder) + (batch,)
    u = pat.PencilArray(plan.input_pencil,
                        torch.randn(shape, generator=gen, device="cuda"))
    plan.backward(plan.forward(u))        # warm-up (cuFFT plans)
    (back, uh), counts = _run_counted(torch, k1, tr, lambda: (
        lambda h: (plan.backward(h), h))(plan.forward(u)))
    err = float((back.data - u.data).abs().max())
    scale = float(u.data.abs().max())
    if not err <= 1e-5 * scale:
        raise AssertionError(f"dct plan round trip {err} > 1e-5 * {scale}")
    r = dict(shape=[n, n, n], batch=batch,
             forward_ms=cuda_ms(torch, lambda: plan.forward(u), 1),
             backward_ms=cuda_ms(torch, lambda: plan.backward(uh), 1),
             roundtrip_max_err=err, max_abs_u=scale, **counts)
    r["profile_forward"] = profile(torch, lambda: plan.forward(u),
                                   f"{n}^3 x {batch} dct x fft x fft forward")
    r["profile_backward"] = profile(torch, lambda: plan.backward(uh),
                                    f"{n}^3 x {batch} dct x fft x fft "
                                    f"backward")
    del u, uh, back
    torch.cuda.empty_cache()
    # small^3: the card against the port on the CPU
    cpu_group = dist.new_group([0], backend="gloo")
    u0 = torch.randn((small, small, small, batch),
                     generator=torch.Generator().manual_seed(SEED + 16))
    spectra = {}
    for dev, group in (("cuda", None), ("cpu", cpu_group)):
        p = pat.PencilFFTPlan(pat.Topology((1, 1), device=dev, group=group),
                              (small,) * 3, **kw)
        spectra[dev] = p.forward(pat.PencilArray.from_global(
            p.input_pencil, u0, 1)).data.cpu()
    rel = max_abs_err(torch, spectra["cuda"], spectra["cpu"]) / float(
        spectra["cpu"].abs().max())
    if not rel <= 1e-5:
        raise AssertionError(f"{small}^3 dct plan card vs CPU: {rel}")
    r["small_card_vs_cpu"] = rel
    log("[fft] dct x fft x fft " + json.dumps(
        {k: (round(v, 4) if k.endswith("_ms") else v) for k, v in r.items()
         if k != "recorded" and not k.startswith("profile")}))
    if r["launches"] <= 0:
        raise AssertionError("the dct plan launched K1 no time")
    return r


def fft_strided(torch, k1, n=512, comps=3):
    """What ``ops/fft.py`` leaves open: one strided-batch ``torch.fft``
    call over dims (0, 1, 2) of an (n, n, n, comps) f32 block with the
    components innermost, against the port's way (K1 moves the components
    outermost, a contiguous batched transform, K1 moves them back), r2c
    forward and c2r inverse; CUDA-event means of 5 calls after a warm-up.
    Both must agree within 1e-5 of the largest |value| (they sum in other
    orders).  A measurement only: the port does not call the strided
    form."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    x = torch.randn((n, n, n, comps), generator=gen, device="cuda")
    dims, s = (0, 1, 2), (n, n, n)
    front, back = (3, 0, 1, 2), (1, 2, 3, 0)

    def fwd_strided():
        return torch.fft.rfftn(x, dim=dims)

    def fwd_k1():
        return k1.permute(torch.fft.rfftn(k1.permute(x, front),
                                          dim=(1, 2, 3)), back)

    y_k1 = fwd_k1()
    err_f = max_abs_err(torch, fwd_strided(), y_k1) / float(
        y_k1.abs().max())
    y = y_k1    # both inverses take the spectrum as the NS state holds it

    def inv_strided():
        return torch.fft.irfftn(y, s=s, dim=dims)

    def inv_k1():
        return k1.permute(torch.fft.irfftn(k1.permute(y, front), s=s,
                                           dim=(1, 2, 3)), back)

    err_i = max_abs_err(torch, inv_strided(), inv_k1()) / float(
        x.abs().max())
    if not (err_f <= 1e-5 and err_i <= 1e-5):
        raise AssertionError(f"strided and K1 FFTs disagree: {err_f} "
                             f"{err_i}")
    r = dict(shape=[n, n, n, comps], forward_strided_ms=cuda_ms(
        torch, fwd_strided, 5), forward_k1_ms=cuda_ms(torch, fwd_k1, 5),
        inverse_strided_ms=cuda_ms(torch, inv_strided, 5),
        inverse_k1_ms=cuda_ms(torch, inv_k1, 5), rel_err_forward=err_f,
        rel_err_inverse=err_i)
    xc = k1.permute(x, front)   # the contiguous transform alone
    r["contiguous_forward_ms"] = cuda_ms(
        torch, lambda: torch.fft.rfftn(xc, dim=(1, 2, 3)), 5)
    log("[fft] strided-batch rfftn/irfftn on the components-innermost "
        "block vs K1 + contiguous + K1: " + json.dumps(
            {k: (round(v, 4) if k.endswith("_ms") else v)
             for k, v in r.items()}))
    del x, y, y_k1, xc
    torch.cuda.empty_cache()
    return r


def simulate_check(torch, model, uh, dt=5e-3, steps=3):
    """``simulate(uh, dt, steps, record_energy=True)`` on the card against
    ``steps`` calls of ``step`` and their energies, each within 1e-6
    relative; the energies a 1-D tensor on the state's device."""
    final, energies = model.simulate(uh, dt, steps, record_energy=True)
    s, want = uh, []
    for _ in range(steps):
        s = model.step(s, dt)
        want.append(float(model.energy(s)))
    rel = float((final.data - s.data).abs().max() / s.data.abs().max())
    got = energies.cpu().tolist()
    rel_e = max(abs(a / b - 1) for a, b in zip(got, want))
    if not (rel <= 1e-6 and rel_e <= 1e-6 and energies.dim() == 1
            and len(got) == steps and energies.device == s.data.device):
        raise AssertionError(f"simulate vs {steps} steps: state {rel}, "
                             f"energies {got} vs {want} on "
                             f"{energies.device}")
    log(f"[ns] 64^3 simulate({steps} steps, record_energy=True) on the card "
        f"= {steps} step calls: state rel {rel:.3e}, energies {got} (rel "
        f"{rel_e:.3e})")
    return dict(rel_state=rel, rel_energy=rel_e, energies=got)


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
        if dev == "cuda":
            sim = simulate_check(torch, m, s)
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
    _reset_k1(k1)
    uh = models.taylor_green(model)
    energies = [float(model.energy(uh))]
    step_ms, step_launches, recorded = [], [], {}
    for _ in range(steps):
        torch.cuda.synchronize()
        n0 = k1.launches
        k1.recorded = recorded     # the steps' K1 classes, not energy's
        t0 = time.perf_counter()
        uh = model.step(uh, dt)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        k1.recorded = None
        step_launches.append(k1.launches - n0)
        energies.append(float(model.energy(uh)))
    launches = k1.launches
    by_instance = dict(k1.launches_by_instance)
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
             simulate=sim,
             max_energy_dev=max(devs), k1_launches=launches,
             k1_launches_by_instance=by_instance,
             k1_launches_per_step=step_launches, recorded=recorded,
             steps=steps)
    log(f"[ns] step ms {[round(t, 2) for t in step_ms]}, peak memory "
        f"{peak / 2**30:.2f} GiB, K1 launches on the main path {launches} "
        f"({step_launches} per step), by instance {by_instance}")
    if launches <= 0:
        raise AssertionError("the main path launched K1 no time")
    # after the counts were read: where one step's time goes
    r["profile"] = profile(torch, lambda: model.step(uh, dt),
                           "512^3 NS RK2 step")
    return r


def _median(xs):
    return sorted(xs)[len(xs) // 2]


def _heat_ic(torch, pat, model):
    """sin(x) cos(y) cos(z) on the model's grid, built on its device."""
    g = pat.localgrid(model.pencil, [
        torch.arange(n, dtype=torch.float64) * (2 * math.pi / n)
        for n in model.shape])
    return g.evaluate(lambda x, y, z: torch.sin(x) * torch.cos(y)
                      * torch.cos(z)).astype(model.dtype)


def heat_check(torch, dist, pat, models, bw, n=1024, small=64, steps=3):
    """HeatFD on (1, 1): ``steps`` RK2 steps of the single Fourier mode at
    n^3 f32, held to the scheme's exact discrete answer u0 (1 + z +
    z^2/2)^steps, z = dt lambda_h, lambda_h = -kappa sum_d (4/h_d^2)
    sin^2(h_d/2), within 1e-5 max|u0|; step ms (median) beside the fused
    bound (a step must read u, write the midpoint, read both and write
    the new u: five field passes over the card's memory rate), peak
    memory and one step's profile; and small^3 on the card against the
    port on the CPU (within 1e-5 max|u0|)."""
    cpu_group = dist.new_group([0], backend="gloo")
    small_states = {}
    for dev, group in (("cuda", None), ("cpu", cpu_group)):
        topo = pat.Topology((1, 1), device=dev, group=group)
        m = models.HeatFD(topo, small)
        u = _heat_ic(torch, pat, m)
        for _ in range(steps):
            u = m.step(u, m.stable_dt())
        small_states[dev] = u.data.cpu()
    rel = float((small_states["cuda"] - small_states["cpu"]).abs().max())
    if not rel <= 1e-5:
        raise AssertionError(f"HeatFD {small}^3 card vs CPU: {rel}")
    topo = pat.Topology((1, 1))
    model = models.HeatFD(topo, n)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    u0 = _heat_ic(torch, pat, model)
    dt = model.stable_dt()
    lam = -model.kappa * sum(4.0 / h ** 2 * math.sin(h / 2) ** 2
                             for h in model.spacing)
    z = dt * lam
    u, step_ms = u0, []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        u = model.step(u, dt)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    amp = (1 + z + z * z / 2) ** steps
    err = float((u.data.double() - u0.data.double() * amp).abs().max())
    scale = float(u0.data.abs().max())
    if not (math.isfinite(err) and err <= 1e-5 * scale):
        raise AssertionError(f"HeatFD {n}^3 off the exact discrete answer: "
                             f"{err} > 1e-5 * {scale}")
    bound = 5 * u0.data.numel() * u0.data.element_size() / bw * 1e3
    r = dict(n=n, steps=steps, dt=dt, amplification=amp, max_err=err,
             max_abs_u0=scale, step_ms=step_ms,
             step_ms_median=_median(step_ms), fused_bound_ms=bound,
             peak_bytes=peak, small_card_vs_cpu=rel)
    log(f"[grid] HeatFD {n}^3 f32 (1,1), {steps} RK2 steps at dt {dt:.6g}: "
        f"max|u - u0 (1+z+z^2/2)^{steps}| {err:.3e} (<= 1e-5 * {scale:.4f}); "
        f"step ms {[round(t, 3) for t in step_ms]} (median "
        f"{r['step_ms_median']:.3f}; fused bound {bound:.3f}), peak memory "
        f"{peak / 2**30:.2f} GiB; "
        f"{small}^3 card vs CPU {rel:.3e}")
    r["profile"] = profile(torch, lambda: model.step(u, dt),
                           f"{n}^3 HeatFD RK2 step",
                           extra_groups=(("stencil_copy",
                                          ("direct_copy", "Memcpy DtoD")),))
    return model, u, r


def rk23_check(torch, dist, pat, models, n=512, small=64, spans=30):
    """``integrate`` (adaptive RK23) of HeatFD's single mode over ``spans``
    times the RK2 stable dt (about 20 accepted steps): accepted and
    rejected steps, ms per trial step, peak memory; at small^3 the card and
    the port on the CPU make the same accept/reject decisions."""
    cpu_group = dist.new_group([0], backend="gloo")
    decided = {}
    for dev, group in (("cuda", None), ("cpu", cpu_group)):
        topo = pat.Topology((1, 1), device=dev, group=group)
        m = models.HeatFD(topo, small)
        _, st = models.integrate(lambda t, v: m.rhs(v), _heat_ic(torch, pat, m),
                                 (0.0, spans * m.stable_dt()), max_steps=100)
        decided[dev] = (st["n_accepted"], st["n_rejected"],
                        st["nan_detected"])
    if decided["cuda"] != decided["cpu"]:
        raise AssertionError(f"RK23 {small}^3 decisions card {decided['cuda']}"
                             f" vs CPU {decided['cpu']}")
    model = models.HeatFD(pat.Topology((1, 1)), n)
    u0 = _heat_ic(torch, pat, model)
    t1 = spans * model.stable_dt()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    u, st = models.integrate(lambda t, v: model.rhs(v), u0, (0.0, t1),
                             max_steps=100)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    trials = st["n_accepted"] + st["n_rejected"]
    lam = -model.kappa * sum(4.0 / h ** 2 * math.sin(h / 2) ** 2
                             for h in model.spacing)
    decay = math.exp(lam * float(st["t"]))
    err = float((u.data.double() - u0.data.double() * decay).abs().max())
    if not (float(st["t"]) >= t1 * (1 - 1e-6) and not st["nan_detected"]
            and err <= 1e-4 and 10 <= st["n_accepted"] <= 30):
        raise AssertionError(f"RK23 {n}^3: {st}, error against "
                             f"exp(lambda_h t) {err}")
    r = dict(n=n, t1=t1, n_accepted=st["n_accepted"],
             n_rejected=st["n_rejected"], ms=secs * 1e3,
             ms_per_trial=secs * 1e3 / trials, peak_bytes=peak,
             max_err_vs_exp=err, small_decisions=list(decided["cuda"]))
    log(f"[grid] RK23 HeatFD {n}^3 f32 over {t1:.6g} ({spans} RK2 dt): "
        f"{st['n_accepted']} accepted, {st['n_rejected']} rejected, "
        f"{r['ms']:.1f} ms, {r['ms_per_trial']:.2f} ms per trial step, peak "
        f"{peak / 2**30:.2f} GiB; max|u - u0 exp(lambda_h t)| {err:.3e}; "
        f"{small}^3 decisions card = CPU {decided['cuda']}")
    return r


def reductions_check(torch, pat, u, bw):
    """sum, norm(2), norm(inf), maximum, dot, any(isnan) over the field
    ``u``: each held to a float64 computation on the card, timed (CUDA
    events, 5 calls), beside its bytes-bound (inputs read once over the
    card's memory rate)."""
    from pencilarrays_tpu_torch.ops import reductions as R

    d = u.data.double()
    nbytes = u.data.numel() * u.data.element_size()
    cases = [
        ("sum", lambda: R.sum(u), float(d.sum()), float(d.abs().sum()), 1),
        ("norm2", lambda: R.norm(u), float(d.square().sum().sqrt()), None, 1),
        ("norminf", lambda: R.norm(u, math.inf), float(d.abs().max()), 0, 1),
        ("maximum", lambda: R.maximum(u), float(d.max()), 0, 1),
        ("dot", lambda: R.dot(u, u), float(d.square().sum()), None, 2),
        ("any_isnan", lambda: R.any(u, pred=torch.isnan),
         bool(torch.isnan(u.data).any()), 0, 1),
    ]
    del d
    out = {}
    for name, fn, want, scale, n_in in cases:
        got = fn()
        got = bool(got) if isinstance(want, bool) else float(got)
        if scale is None:
            ok = abs(got - want) <= 1e-5 * abs(want)
        elif scale == 0:
            ok = got == want
        else:      # a sum that cancels: held to the sum of magnitudes
            ok = abs(got - want) <= 1e-6 * scale
        if not ok:
            raise AssertionError(f"reduction {name}: {got} vs float64 {want}")
        ms = cuda_ms(torch, fn, 5)
        bound = n_in * nbytes / bw * 1e3
        out[name] = dict(value=got, float64=want, ms=ms, bound_ms=bound,
                         of_bound=bound / ms, bytes=n_in * nbytes)
    log("[grid] reductions over the field " + json.dumps(
        {k: {kk: (round(vv, 4) if isinstance(vv, float) and kk != "value"
                  and kk != "float64" else vv) for kk, vv in v.items()}
         for k, v in out.items()}))
    return out


def random_check(torch, dist, pat, n=1024, small=64, seed=11):
    """``uniform`` and ``normal`` fills at n^3 f32: fill ms (CUDA events),
    moments within 5 sigma; ``uniform`` on the card bit-identical to the
    port on the CPU at small^3."""
    from pencilarrays_tpu_torch.ops import random as Rnd

    cpu_group = dist.new_group([0], backend="gloo")
    fills = {}
    for dev, group in (("cuda", None), ("cpu", cpu_group)):
        pen = pat.Pencil(pat.Topology((1, 1), device=dev, group=group),
                         (small,) * 3, permutation=pat.Permutation(2, 0, 1))
        fills[dev] = Rnd.uniform(pen, seed).data.cpu()
    if not same_bits(torch, fills["cuda"], fills["cpu"]):
        raise AssertionError(f"uniform {small}^3 card differs from the CPU")
    pen = pat.Pencil(pat.Topology((1, 1)), (n,) * 3)
    N = n ** 3
    out = {}
    for name, fn, mean, var in (
            ("uniform", lambda: Rnd.uniform(pen, seed), 0.5, 1 / 12),
            ("normal", lambda: Rnd.normal(pen, seed), 0.0, 1.0)):
        x = fn().data
        m = float(x.double().mean())
        v = float(x.double().var())
        tol_m = 5 * math.sqrt(var / N)
        tol_v = 5 * math.sqrt((1 / 180 if name == "uniform" else 2.0) / N)
        if not (abs(m - mean) <= tol_m and abs(v - var) <= tol_v):
            raise AssertionError(f"{name} moments {m}, {v}")
        del x
        ms = cuda_ms(torch, fn, 2)
        out[name] = dict(mean=m, var=v, fill_ms=ms,
                         bytes_written=N * 4)
    log(f"[grid] random fills {n}^3 f32: " + json.dumps(out)
        + f"; uniform {small}^3 card = CPU bit for bit")
    return out


def spectral_ops_check(torch, pat, k1, tr, n=512):
    """The spectral operators on the NS plan (512^3 f32, (1, 1)):
    gradient of sin(3x) cos(2y) sin(z) against its analytic derivative
    within 1e-4 max|grad f| (a spectral derivative multiplies the f32
    transform's rounding of each mode by its wavenumber, up to n/2 = 256,
    so 2^-24 * 256 * max|f| = 1.5e-5 is the scale of its error;
    ``examples/gradient_spectral.py`` holds f32 to 1e-3);
    laplacian(solve_poisson(f^)) = f^ with the mean mode removed within
    1e-5 max|f^|; divergence(curl(u^)) within 1e-6 max|u^| of 0.  Vector
    fields go through the plan as one array with a component dim, whose
    FFT stages move it with K1.  K1's launches over the run, counted from
    0; then each call's time (CUDA events, 3 calls after a warm-up)."""
    from pencilarrays_tpu_torch import ops

    topo = pat.Topology((1, 1))
    plan = pat.PencilFFTPlan(topo, (n,) * 3, real=True, dtype=torch.float32,
                             batch=3)
    g = pat.localgrid(plan.input_pencil, [
        torch.arange(m, dtype=torch.float64) * (2 * math.pi / m)
        for m in (n,) * 3])

    def field(f):
        return g.evaluate(f).astype(torch.float32)

    f = field(lambda x, y, z: torch.sin(3 * x) * torch.cos(2 * y)
              * torch.sin(z))
    vec = pat.PencilArray.stack([
        field(lambda x, y, z: torch.sin(y) * torch.cos(z)),
        field(lambda x, y, z: torch.sin(z) * torch.cos(x)),
        field(lambda x, y, z: torch.sin(x) * torch.cos(y))])

    def run():
        fh = plan.forward(f)
        gh = ops.gradient(plan, fh)
        grads = plan.backward(gh)
        ph = ops.solve_poisson(plan, fh)
        lap = ops.laplacian(plan, ph)
        uh = plan.forward(vec)
        w = ops.curl(plan, uh)
        return fh, gh, grads, ph, lap, uh, w, ops.divergence(plan, w)

    (fh, gh, grads, ph, lap, uh, w, div), counts = _run_counted(
        torch, k1, tr, run)
    ms = {name: cuda_ms(torch, fn, 3) for name, fn in (
        ("forward", lambda: plan.forward(f)),
        ("gradient", lambda: ops.gradient(plan, fh)),
        ("backward_vector", lambda: plan.backward(gh)),
        ("solve_poisson", lambda: ops.solve_poisson(plan, fh)),
        ("laplacian", lambda: ops.laplacian(plan, ph)),
        ("forward_vector", lambda: plan.forward(vec)),
        ("curl", lambda: ops.curl(plan, uh)),
        ("divergence", lambda: ops.divergence(plan, w)))}
    X, Y, Z = (c.double() for c in g.components())
    want = [3 * torch.cos(3 * X) * torch.cos(2 * Y) * torch.sin(Z),
            -2 * torch.sin(3 * X) * torch.sin(2 * Y) * torch.sin(Z),
            torch.sin(3 * X) * torch.cos(2 * Y) * torch.cos(Z)]
    err_g = max(float((grads.data[..., d].double() - want[d]).abs().max())
                for d in range(3))
    mean_free = fh.data.clone()
    mean_free[(0,) * 3] = 0
    err_p = max_abs_err(torch, lap.data, mean_free)
    scale_p = float(fh.data.abs().max())
    err_d = float(div.data.abs().max())
    bar_d = 1e-6 * float(uh.data.abs().max())
    if not (err_g <= 1e-4 * 3 and err_p <= 1e-5 * scale_p
            and err_d <= bar_d):
        raise AssertionError(f"spectral ops: gradient {err_g}, poisson "
                             f"{err_p} (max {scale_p}), div curl {err_d} "
                             f"(bar {bar_d})")
    if counts["launches"] <= 0:
        raise AssertionError("the spectral operators' run launched K1 no "
                             "time")
    r = dict(ms=ms, err_gradient=err_g, err_poisson=err_p,
             max_abs_fhat=scale_p, div_curl=err_d, div_curl_bar=bar_d,
             **counts)
    log(f"[grid] spectral ops {n}^3 f32 (NS plan, (1,1)) " + json.dumps(
        {k: v for k, v in r.items() if k != "recorded"}))
    return r


def many_check(torch, pat, k1, tr, n=1024):
    """``ManyPencilArray`` over phase 3's x/y/z pencils at n^3 f32 (the
    same random field): each hop of a ``cycle`` and the walk back
    bit-identical to phase 3's ``AllToAll()`` hops; then one timed
    cycle and back (K1 launches by instance, peak memory) beside the same
    four hops by ``pat.transpose`` holding only the current array."""
    topo = pat.Topology((1, 1))
    shape = (n, n, n)
    px = pat.Pencil(topo, shape, (1, 2), permutation=pat.Permutation(1, 2, 0))
    py = pat.Pencil(topo, shape, (0, 2), permutation=pat.Permutation(0, 2, 1))
    pz = pat.Pencil(topo, shape, (0, 1))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    x = torch.randn(shape, generator=gen, device="cuda")   # phase 3's field
    ref, v = [], pat.PencilArray(px, x)
    for pen in (py, pz, py, px):
        v = pat.transpose(v, pen)
        ref.append(v.data)
    A = pat.ManyPencilArray(px, py, pz, first=pat.PencilArray(px, x.clone()))
    got = [a.data for a in A.cycle()][1:]   # each read before its hop
    got.append(A.transpose_to(1).data)
    got.append(A.transpose_to(0).data)
    for i, (a, b) in enumerate(zip(got, ref)):
        if not same_bits(torch, a, b):
            raise AssertionError(f"ManyPencilArray hop {i + 1} differs from "
                                 f"the AllToAll hop")
    del ref, got, v, A
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # each run takes its input from a box, so that nothing else holds it
    def chain(box):
        v = pat.PencilArray(px, box.pop())
        for pen in (py, pz, py, px):
            v = pat.transpose(v, pen)
        return v

    def many(box):
        A = pat.ManyPencilArray(px, py, pz,
                                first=pat.PencilArray(px, box.pop()))
        for _ in A.cycle():
            pass
        return A.transpose_to(0)

    out = {}
    for name, fn in (("transpose_chain", chain), ("many", many)):
        fn([x.clone()])                           # warm-up
        box = [x.clone()]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        res, counts = _run_counted(torch, k1, tr, lambda: fn(box))
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        if not same_bits(torch, res.data, x):
            raise AssertionError(f"{name}: the round trip is not "
                                 f"bit-identical")
        del res
        out[name] = dict(ms=secs * 1e3, peak_bytes=peak,
                         peak_above_input=peak - base, **counts)
        torch.cuda.empty_cache()
    if out["many"]["launches"] <= 0:
        raise AssertionError("ManyPencilArray launched K1 no time")
    log(f"[grid] ManyPencilArray {n}^3 f32 x->y->z->y->x every hop "
        f"bit-identical to phase 3's AllToAll hops; " + json.dumps(
            {k: {kk: vv for kk, vv in v.items() if kk != "recorded"}
             for k, v in out.items()}))
    del x
    torch.cuda.empty_cache()
    return out["many"] | {"transpose_chain": {
        k: v for k, v in out["transpose_chain"].items() if k != "recorded"}}


def phase_grid_toolbox(torch, dist, pat, models, k1, tr, bw):
    """Phase 5b: the grid toolbox and the halo-exchange path.  It leaves
    the card as it found it: cuFFT's plan cache (its workspaces are
    allocations) is cleared at the end."""
    t0 = time.perf_counter()
    before = (torch.cuda.memory_allocated(), torch.cuda.mem_get_info()[0])
    _, u, heat = heat_check(torch, dist, pat, models, bw)
    red = reductions_check(torch, pat, u, bw)
    del u
    torch.cuda.empty_cache()
    r = dict(heat=heat, reductions=red,
             rk23=rk23_check(torch, dist, pat, models),
             random=random_check(torch, dist, pat),
             spectral_ops=spectral_ops_check(torch, pat, k1, tr),
             many=many_check(torch, pat, k1, tr))
    torch.backends.cuda.cufft_plan_cache.clear()
    torch.cuda.empty_cache()
    r["seconds"] = time.perf_counter() - t0
    after = (torch.cuda.memory_allocated(), torch.cuda.mem_get_info()[0])
    log(f"[grid] phase 5b took {r['seconds']:.1f} s; allocated / free on "
        f"the card before {before[0] / 2**30:.2f} / {before[1] / 2**30:.2f} "
        f"GiB, after {after[0] / 2**30:.2f} / {after[1] / 2**30:.2f} GiB")
    return r


# -- phase 5c: parallel I/O and crash-safe checkpoints ----------------------

# the phase's files: a directory of the checkout (listed in .gitignore),
# deleted at the phase's end
IO_DIR = "chip_smoke_io"


def _io_counted(torch, k1, acc, fn):
    """``fn()`` with K1's counts from 0, its launches, classes and seconds
    added to ``acc``; returns ``(result, seconds)``."""
    torch.cuda.synchronize()
    _reset_k1(k1)
    k1.recorded = {}
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    acc["launches"] += k1.launches
    for inst, c in k1.launches_by_instance.items():
        acc["launches_by_instance"][inst] += c
    for cls, c in k1.recorded.items():
        acc["recorded"][cls] = acc["recorded"].get(cls, 0) + c
    k1.recorded = None
    return res, secs


def _stage_ms(stats):
    return {k[:-2] + "_ms": v * 1e3 for k, v in stats.items()
            if k.endswith("_s")}


def _dir_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def io_field_check(torch, pat, k1, io, d, acc, n):
    """An n^3 f32 field on a z-pencil (memory order (2, 0, 1)) written by
    ``BinaryDriver`` in the discontiguous and the chunks layouts, each read
    back into phase 3's x-pencil (memory order (1, 2, 0)) and held bit for
    bit to the source moved there on the card (``reshard``, Gspmd: one K1
    permute); write and read ms and GB/s by stage, and the path the
    bytes took (the native library, or the phase fails)."""
    from pencilarrays_tpu_torch.io import native

    topo = pat.Topology((1, 1))
    shape = (n, n, n)
    pz = pat.Pencil(topo, shape, (0, 1), permutation=pat.Permutation(2, 0, 1))
    px = pat.Pencil(topo, shape, (1, 2), permutation=pat.Permutation(1, 2, 0))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 41)
    src = pat.PencilArray(pz, torch.randn(pz.padded_size_local(
        pat.MemoryOrder), generator=gen, device="cuda"))
    ref = pat.reshard(src, px, method=pat.Gspmd()).data
    nbytes = src.sizeof_global()
    out = {}
    for layout in ("discontiguous", "chunks"):
        path = os.path.join(d, f"field_{layout}.bin")

        def write():
            with io.open_file(io.BinaryDriver(), path, write=True,
                              create=True) as f:
                f.write("u", src, chunks=layout == "chunks")
                return dict(f.stats)

        def read():
            with io.open_file(io.BinaryDriver(), path, read=True) as f:
                return f.read("u", px), dict(f.stats)

        wstats, wsecs = _io_counted(torch, k1, acc, write)
        (y, rstats), rsecs = _io_counted(torch, k1, acc, read)
        if not same_bits(torch, y.data, ref):
            raise AssertionError(f"[io] {layout}: the field read into the "
                                 f"x-pencil differs from the source")
        del y
        r = dict(write_ms=wsecs * 1e3, write_GBps=nbytes / wsecs / 1e9,
                 write_stages=_stage_ms(wstats), write_path=wstats["path"],
                 read_ms=rsecs * 1e3, read_GBps=nbytes / rsecs / 1e9,
                 read_stages=_stage_ms(rstats), read_path=rstats["path"],
                 file_bytes=os.path.getsize(path))
        log(f"[io] field {n}^3 f32 {layout}: z-pencil (2,0,1) -> file -> "
            f"x-pencil (1,2,0) bit-identical to the source; " + json.dumps(r))
        out[layout] = r
        os.unlink(path)
        os.unlink(path + ".json")
    path = out["discontiguous"]["write_path"]
    if not path.startswith("native_mt("):
        raise AssertionError(f"[io] the discontiguous write took {path}, "
                             f"not the native library (g++ build: "
                             f"{native.build_info})")
    log(f"[io] native library {native.build_info}; the discontiguous write "
        f"and read took {path} (pwrite/pread threads)")
    del src, ref
    torch.cuda.empty_cache()
    return out


def io_ns_check(torch, pat, models, k1, io, resilience, d, acc, n):
    """NS Taylor-Green n^3 f32 checkpoint-restart: three RK2 steps, each
    saved by ``CheckpointManager(keep=2)`` over ``BinaryDriver``; the
    retained steps, a restore of step 2 stepped once against the
    uninterrupted step 3, step 3 read into another pencil against
    ``transpose`` of the state; save ms by stage and peak device memory
    above the state (at most one component's staged block), restore ms
    with and without verification, the checkpoint's bytes."""
    model = models.NavierStokesSpectral(pat.Topology((1, 1)), n,
                                        viscosity=1e-2, dtype=torch.float32)
    pen = model.plan.output_pencil
    uh = models.taylor_green(model)
    comp = math.prod(pen.size_global()) * uh.data.element_size()
    mgr = resilience.CheckpointManager(os.path.join(d, "ns"), keep=2)
    dt, states, saves = 5e-3, {}, []
    for step in (1, 2, 3):
        uh = model.step(uh, dt)
        states[step] = uh
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        _, secs = _io_counted(torch, k1, acc,
                              lambda: mgr.save(step, {"uh": uh}))
        peak = torch.cuda.max_memory_allocated() - base
        s = dict(step=step, ms=secs * 1e3, peak_above_state=peak,
                 stages=_stage_ms(mgr.stats), path=mgr.stats["path"])
        log(f"[io] NS {n}^3 save step {step}: " + json.dumps(s))
        if peak > comp:
            raise AssertionError(f"[io] a save peaked {peak} bytes above "
                                 f"the state, over one component's staged "
                                 f"block ({comp})")
        saves.append(s)
    del states[1]
    if mgr.steps() != [2, 3] or mgr.latest_valid() != 3:
        raise AssertionError(f"[io] steps {mgr.steps()}, latest valid "
                             f"{mgr.latest_valid()}: want [2, 3] and 3")
    back, verify_s = _io_counted(
        torch, k1, acc, lambda: mgr.restore(2).read("uh", pen, verify=True))
    again, plain_s = _io_counted(
        torch, k1, acc, lambda: mgr.restore(2).read("uh", pen, verify=False))
    for got in (back, again):
        if not same_bits(torch, got.data, states[2].data):
            raise AssertionError("[io] restored step 2 differs from the "
                                 "saved state")
    del again
    stepped = model.step(back, dt).data
    want = states[3].data
    restart_bits = same_bits(torch, stepped, want)
    diff = max_abs_err(torch, stepped, want)
    scale = float(want.abs().max())
    if not restart_bits and not diff <= 1e-6 * scale:
        raise AssertionError(f"[io] restart step differs by {diff}, over "
                             f"1e-6 of max|u_hat| {scale}")
    del stepped, back
    other = pat.Pencil(pen.topology, pen.size_global(), (0, 2),
                       permutation=pat.Permutation(0, 2, 1))
    moved, moved_s = _io_counted(
        torch, k1, acc, lambda: mgr.restore(3).read("uh", other))
    if not same_bits(torch, moved.data, pat.transpose(states[3],
                                                      other).data):
        raise AssertionError("[io] step 3 read into another pencil differs "
                             "from transpose of the state")
    del moved, states
    r = dict(saves=saves, restore_verify_ms=verify_s * 1e3,
             restore_ms=plain_s * 1e3, restore_other_pencil_ms=moved_s * 1e3,
             checkpoint_bytes=_dir_bytes(mgr._step_dir(3)),
             component_bytes=comp, restart_bit_identical=restart_bits,
             restart_max_abs_diff=diff, max_abs_u_hat=scale)
    log(f"[io] NS {n}^3 f32 checkpoint-restart (keep=2): steps [2, 3], "
        f"latest valid 3; restart from step 2 "
        f"{'bit-identical to' if restart_bits else 'within 1e-6 of'} the "
        f"uninterrupted step 3; step 3 read into (0,2) perm (0,2,1) = "
        f"transpose of the state; " + json.dumps(
            {k: v for k, v in r.items() if k != "saves"}))
    torch.backends.cuda.cufft_plan_cache.clear()
    torch.cuda.empty_cache()
    return r


_DRILL = """
import sys
sys.path.insert(0, {root!r})
import torch
import pencilarrays_tpu_torch as pat
from pencilarrays_tpu_torch.resilience import (
    CheckpointManager, CorruptCheckpointError, InjectedFault)
topo = pat.Topology((1, 1))
pen = pat.Pencil(topo, ({n}, {n}, {n}), (1, 2),
                 permutation=pat.Permutation(1, 2, 0))
gen = torch.Generator(device="cuda").manual_seed({seed})
x = pat.PencilArray(pen, torch.randn(
    pen.padded_size_local(pat.MemoryOrder), generator=gen, device="cuda"))
{body}
"""

_DRILL_BODIES = {
    "save": """
CheckpointManager({dir!r}, keep=4).save({step}, {{"u": x}})
print("saved step {step}", flush=True)
""",
    "restore": """
try:
    CheckpointManager({dir!r}).restore({step}, verify=True).read("u", pen)
except CorruptCheckpointError as e:
    assert e.dataset == "u" and e.block is not None, e
    print("refused:", e, flush=True)
else:
    raise SystemExit("a flipped byte was not detected")
""",
    "hop": """
py = pat.Pencil(topo, pen.size_global(), (0, 2),
                permutation=pat.Permutation(0, 2, 1))
try:
    pat.transpose(x, py)
except InjectedFault as e:
    print("raised:", repr(e), flush=True)
else:
    raise SystemExit("an armed hop.exchange did not raise")
""",
}


def _drill_start(root, kind, spec, **kw):
    """A drill in a subprocess on the card (a kill really kills), started:
    the port's code of ``_DRILL_BODIES[kind]`` with ``spec`` armed."""
    from pencilarrays_tpu_torch.resilience import faults

    env = dict(os.environ)
    env.pop(faults.ENV_VAR, None)
    if spec:
        env[faults.ENV_VAR] = spec
    kw.setdefault("n", 64)
    kw.setdefault("seed", SEED + 51)
    code = _DRILL.format(root=root, body=_DRILL_BODIES[kind].format(**kw),
                         **kw)
    return subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _drill_end(p):
    """A started drill's return code, stdout and stderr (it is killed
    after 180 s)."""
    try:
        so, se = p.communicate(timeout=180)
    except subprocess.TimeoutExpired:
        p.kill()
        so, se = p.communicate()
    return p.returncode, so.strip(), se.strip()


def _drill(root, kind, spec, **kw):
    return _drill_end(_drill_start(root, kind, spec, **kw))


def io_drills(torch, pat, resilience, d):
    """The crash drills on the card, each in a subprocess: a kill before
    the commit leaves the previous step and the next save sweeps it; two
    transient sidecar-flush faults are retried; a flipped byte is refused
    by name; an armed ``hop.exchange`` raises from ``transpose``."""
    root = os.path.dirname(os.path.abspath(__file__))
    # the hop drill shares nothing with the checkpoint drills: it runs
    # beside them
    hop = _drill_start(root, "hop", "hop.exchange:error")
    try:
        return _io_drills(torch, pat, resilience, d, root, hop)
    finally:
        if hop.poll() is None:
            hop.kill()
            hop.communicate()


def _io_drills(torch, pat, resilience, d, root, hop):
    import json as _json

    ck = os.path.join(d, "drills")
    mgr = resilience.CheckpointManager(ck, keep=4)
    topo = pat.Topology((1, 1))
    pen = pat.Pencil(topo, (64, 64, 64), (1, 2),
                     permutation=pat.Permutation(1, 2, 0))
    mgr.save(1, {"u": pat.PencilArray.zeros(pen)})
    out = {}
    rc, so, se = _drill(root, "save", "ckpt.commit:kill", dir=ck, step=2)
    torn = sorted(e for e in os.listdir(ck) if e.startswith(".tmp-"))
    if rc != -9 or mgr.latest_valid() != 1 or not torn:
        raise AssertionError(f"[io] drill ckpt.commit:kill: rc {rc}, latest "
                             f"valid {mgr.latest_valid()}, temp dirs {torn}"
                             f"\n{so}\n{se[-2000:]}")
    out["commit_kill"] = dict(rc=rc, latest_valid=1, torn=torn)
    rc, so, se = _drill(root, "save", "io.flush_meta:error*2", dir=ck,
                        step=3)
    retries = se.count("failed (attempt")
    left = sorted(os.listdir(ck))
    if rc != 0 or retries != 2 or mgr.latest_valid() != 3 or \
            left != ["step-00000001", "step-00000003"]:
        raise AssertionError(f"[io] drill io.flush_meta:error*2: rc {rc}, "
                             f"{retries} retries, latest valid "
                             f"{mgr.latest_valid()}, entries {left}"
                             f"\n{so}\n{se[-2000:]}")
    out["flush_retried"] = dict(rc=rc, retries=retries, entries=left)
    step3 = os.path.join(ck, "step-00000003")
    with open(os.path.join(step3, "data.bin.json")) as f:
        offset = _json.load(f)["datasets"][0]["offset_bytes"]
    with open(os.path.join(step3, "data.bin"), "r+b") as f:
        f.seek(offset + 4096)
        b = f.read(1)
        f.seek(offset + 4096)
        f.write(bytes([b[0] ^ 0x01]))
    rc, so, se = _drill(root, "restore", None, dir=ck, step=3)
    if rc != 0 or "'u' block" not in so:
        raise AssertionError(f"[io] drill flipped byte: rc {rc}\n{so}\n"
                             f"{se[-2000:]}")
    out["flipped_byte"] = dict(rc=rc, refused=so)
    rc, so, se = _drill_end(hop)
    if rc != 0 or "InjectedFault" not in so:
        raise AssertionError(f"[io] drill hop.exchange:error: rc {rc}\n{so}"
                             f"\n{se[-2000:]}")
    out["hop_exchange"] = dict(rc=rc, raised=so)
    log("[io] drills on the card, each a subprocess: " + json.dumps(out))
    return out


def io_hdf5_check(torch, pat, k1, io, d, acc, n):
    """The HDF5 driver when h5py imports: an n^3 f32 field written from a
    z-pencil and read into the x-pencil, bit for bit."""
    if not io.has_hdf5():
        log("[io] hdf5: not run, h5py does not import on this machine")
        return None
    topo = pat.Topology((1, 1))
    shape = (n, n, n)
    pz = pat.Pencil(topo, shape, (0, 1), permutation=pat.Permutation(2, 0, 1))
    px = pat.Pencil(topo, shape, (1, 2), permutation=pat.Permutation(1, 2, 0))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 61)
    src = pat.PencilArray(pz, torch.randn(pz.padded_size_local(
        pat.MemoryOrder), generator=gen, device="cuda"))
    path = os.path.join(d, "field.h5")

    def write():
        with io.open_file(io.HDF5Driver(), path, write=True,
                          create=True) as f:
            f.write("u", src)

    def read():
        with io.open_file(io.HDF5Driver(), path, read=True) as f:
            return f.read("u", px)

    _, wsecs = _io_counted(torch, k1, acc, write)
    y, rsecs = _io_counted(torch, k1, acc, read)
    if not same_bits(torch, y.data, pat.reshard(src, px,
                                                method=pat.Gspmd()).data):
        raise AssertionError("[io] hdf5: the field read back differs")
    r = dict(write_ms=wsecs * 1e3, read_ms=rsecs * 1e3,
             file_bytes=os.path.getsize(path))
    log(f"[io] hdf5: ran; {n}^3 f32 z-pencil -> file -> x-pencil "
        f"bit-identical; " + json.dumps(r))
    return r


def io_orbax_check(torch, pat, k1, io, d, acc, n):
    """The Orbax-layout driver (TensorStore alone) when tensorstore
    imports: an n^3 f32 field written from a z-pencil and read into the
    x-pencil, bit for bit."""
    if not io.has_orbax():
        log("[io] orbax: not run, tensorstore does not import on this "
            "machine")
        return None
    topo = pat.Topology((1, 1))
    shape = (n, n, n)
    pz = pat.Pencil(topo, shape, (0, 1), permutation=pat.Permutation(2, 0, 1))
    px = pat.Pencil(topo, shape, (1, 2), permutation=pat.Permutation(1, 2, 0))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 62)
    src = pat.PencilArray(pz, torch.randn(pz.padded_size_local(
        pat.MemoryOrder), generator=gen, device="cuda"))
    path = os.path.join(d, "orbax")

    def write():
        with io.open_file(io.OrbaxDriver(), path, write=True,
                          create=True) as f:
            f.write("u", src)

    def read():
        with io.open_file(io.OrbaxDriver(), path, read=True) as f:
            return f.read("u", px)

    _, wsecs = _io_counted(torch, k1, acc, write)
    y, rsecs = _io_counted(torch, k1, acc, read)
    if not same_bits(torch, y.data, pat.reshard(src, px,
                                                method=pat.Gspmd()).data):
        raise AssertionError("[io] orbax: the field read back differs")
    r = dict(write_ms=wsecs * 1e3, read_ms=rsecs * 1e3,
             dir_bytes=_dir_bytes(path))
    log(f"[io] orbax: ran; {n}^3 f32 z-pencil -> Orbax item -> x-pencil "
        f"bit-identical; " + json.dumps(r))
    return r


def phase_io(torch, pat, models, k1, n_field=1024, n_ns=512, n_h5=512,
             n_orbax=256):
    """Phase 5c: parallel I/O and crash-safe checkpoints on the card, in
    ``IO_DIR`` (checked for three times the bytes the phase writes first,
    deleted at the end).  K1's launches and classes over the phase's
    writes and reads count under the path ``io``."""
    import shutil

    from pencilarrays_tpu_torch import io, resilience

    t0 = time.perf_counter()
    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), IO_DIR)
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    try:
        usage = shutil.disk_usage(d)
        spectral = 3 * n_ns * n_ns * (n_ns // 2 + 1) * 8
        writes = (2 * 4 * n_field ** 3 + 3 * spectral
                  + (4 * n_h5 ** 3 if io.has_hdf5() else 0)
                  + (4 * n_orbax ** 3 if io.has_orbax() else 0)
                  + 3 * 4 * 64 ** 3)
        log(f"[io] {d}: disk_usage total {usage.total}, used {usage.used}, "
            f"free {usage.free} bytes; the phase writes {writes} bytes")
        if usage.free < 3 * writes:
            raise AssertionError(
                f"[io] {d} has {usage.free} bytes free, under three times "
                f"the {writes} bytes phase 5c writes")
        acc = dict(launches=0, recorded={}, launches_by_instance={
            i: 0 for i in k1.INSTANCES})
        r = dict(field=io_field_check(torch, pat, k1, io, d, acc, n_field),
                 ns=io_ns_check(torch, pat, models, k1, io, resilience, d,
                                acc, n_ns),
                 drills=io_drills(torch, pat, resilience, d),
                 hdf5=io_hdf5_check(torch, pat, k1, io, d, acc, n_h5),
                 orbax=io_orbax_check(torch, pat, k1, io, d, acc, n_orbax))
    finally:
        shutil.rmtree(d, ignore_errors=True)
    r.update(acc)
    r["seconds"] = time.perf_counter() - t0
    log(f"[io] phase 5c took {r['seconds']:.1f} s; K1 launches on the io "
        f"path {acc['launches']}, by instance {acc['launches_by_instance']}")
    if acc["launches"] <= 0:
        raise AssertionError("the io path launched K1 no time")
    return r


# -- phase 5d: the engine, async loops, compiled plans, obs, benchtime -------

ENGINE_DIR = "chip_smoke_engine"


def _step_ms(log_records):
    """The median host time a dispatch of the loop took (``run_s``): the
    consumer's issue of one step, paced by the launch queue."""
    return _median([r.run_s * 1e3 for r in log_records
                    if r.label.startswith("ns.step")])


def engine_ns_check(torch, pat, models, k1, resilience, engine, analysis,
                    d, acc, n, steps, every):
    """Phase 5d (a): NS Taylor-Green n^3 f32 RK2, ``steps`` steps saved
    every ``every`` by ``CheckpointManager(keep=2)``, once as a
    synchronous loop (``step``, then ``save``) and once by ``run_async``:
    the final states bit-identical, each kept step restored from the
    async directory bit-identical to the sync loop's, the saves on the
    host pool, the dispatch log verified; wall ms of both loops, the
    share of the save time hidden, the median step inside the async loop
    and the async loop's peak above the sync loop's (at most one state
    plus one staged component)."""
    model = models.NavierStokesSpectral(pat.Topology((1, 1)), n,
                                        viscosity=1e-2, dtype=torch.float32)
    pen = model.plan.output_pencil
    dt = 5e-3
    uh0 = models.taylor_green(model)
    state = uh0.data.numel() * uh0.data.element_size()
    comp = state // 3
    mgr_s = resilience.CheckpointManager(os.path.join(d, "sync"), keep=2)
    mgr_a = resilience.CheckpointManager(os.path.join(d, "async"), keep=2)
    model.step(uh0, dt)                          # warm: cuFFT plans, K1
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    save_s = []
    t0 = time.perf_counter()
    uh = uh0
    for k in range(1, steps + 1):
        uh = model.step(uh, dt)
        if k % every == 0:
            t1 = time.perf_counter()
            mgr_s.save(k, {"uh": uh})
            save_s.append(time.perf_counter() - t1)
    torch.cuda.synchronize()
    sync_ms = (time.perf_counter() - t0) * 1e3
    sync_peak = torch.cuda.max_memory_allocated() - base
    sync_final = uh
    del uh

    eng = engine.Engine("chip-ns")
    async_save_s, save = [], mgr_a.save

    def timed_save(*args, **kwargs):        # each save's own seconds
        t1 = time.perf_counter()
        out = save(*args, **kwargs)
        async_save_s.append(time.perf_counter() - t1)
        return out

    mgr_a.save = timed_save
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()

    def run():
        pipe = model.run_async(uh0, dt, steps, engine=eng, checkpoint=mgr_a,
                               checkpoint_every=every)
        return pipe, pipe.result(900)

    pipe, final = _io_counted(torch, k1, acc, run)[0]
    async_ms = (time.perf_counter() - t0) * 1e3
    async_peak = torch.cuda.max_memory_allocated() - base
    stats = eng.stats()
    log_records = eng.dispatch_log()
    cert = analysis.verify_dispatch_log(log_records, source="chip-ns")
    eng.close()
    if not same_bits(torch, final.data, sync_final.data):
        raise AssertionError("[engine] the async loop's final state differs "
                             "from the sync loop's")
    del final, sync_final
    want = [k for k in range(every, steps + 1, every)][-2:]
    if mgr_a.steps() != want or mgr_s.steps() != want:
        raise AssertionError(f"[engine] kept steps {mgr_a.steps()} (async), "
                             f"{mgr_s.steps()} (sync): want {want}")
    for k in want:
        a = mgr_a.restore(k).read("uh", pen, verify=True)
        s = mgr_s.restore(k).read("uh", pen, verify=False)
        if not same_bits(torch, a.data, s.data):
            raise AssertionError(f"[engine] step {k} restored from the "
                                 f"async directory differs from the sync "
                                 f"loop's state")
        del a, s
    if stats["host_tasks"] != len(pipe.saves) or len(pipe.saves) != \
            steps // every:
        raise AssertionError(f"[engine] host tasks {stats['host_tasks']}, "
                             f"saves {len(pipe.saves)}")
    if cert["dispatches"] != steps or not cert["order_ok"]:
        raise AssertionError(f"[engine] dispatch log {cert}")
    extra = async_peak - sync_peak
    step_ms = _step_ms(log_records)
    r = dict(n=n, steps=steps, every=every, sync_ms=sync_ms,
             async_ms=async_ms, hidden=1.0 - async_ms / sync_ms,
             sync_save_s=save_s, save_total_s=sum(save_s),
             async_save_s=async_save_s,
             async_step_ms=step_ms,
             step_run_ms=[r.run_s * 1e3 for r in log_records],
             sync_peak=sync_peak, async_peak=async_peak,
             peak_above_sync=extra, state_bytes=state,
             component_bytes=comp, host_tasks=stats["host_tasks"],
             dispatch_busy_s=stats["dispatch_busy_s"],
             host_busy_s=stats["host_busy_s"], certificate=cert,
             kept=want)
    log(f"[engine] NS {n}^3 f32 RK2, {steps} steps, a save every {every} "
        f"(keep=2): sync loop {sync_ms:.1f} ms (saves "
        f"{[round(s, 3) for s in save_s]} s), run_async {async_ms:.1f} ms, "
        f"save time hidden 1 - async/sync = {r['hidden']:.4f} (its saves "
        f"{[round(t, 3) for t in async_save_s]} s, each from the host "
        f"task's start: its step's device work included); final "
        f"states bit-identical, steps {want} restored from the async "
        f"directory = the sync loop's; host tasks {stats['host_tasks']}; "
        f"median step in the async loop {r['async_step_ms']:.2f} ms; "
        f"peak above the sync loop's {extra} bytes (state {state}, "
        f"component {comp}); dispatch log {cert}")
    if extra > state + comp:
        raise AssertionError(f"[engine] the async loop peaked {extra} bytes "
                             f"above the sync loop, over one state and one "
                             f"staged component ({state + comp})")
    del uh0
    torch.cuda.empty_cache()
    return model, r


def engine_async_calls_check(torch, pat, model, k1, engine, analysis, acc):
    """Phase 5d (b): ``step_async`` and ``forward_async``/
    ``backward_async`` on the 512^3 plan bit-identical to the synchronous
    calls, through one engine, with its log verified."""
    from pencilarrays_tpu_torch.models import taylor_green

    dt = 5e-3
    uh = taylor_green(model)
    plan = model.plan
    u = model.to_physical(uh)
    eng = engine.Engine("chip-async")

    def run():
        s = model.step_async(uh, dt, engine=eng).result(300)
        f = plan.forward_async(u, engine=eng).result(300)
        b = plan.backward_async(f, engine=eng).result(300)
        return s, f, b

    s, f, b = _io_counted(torch, k1, acc, run)[0]
    cert = analysis.verify_dispatch_log(eng.dispatch_log(),
                                        source="chip-async")
    eng.close()
    ok = dict(step=same_bits(torch, s.data, model.step(uh, dt).data),
              forward=same_bits(torch, f.data, plan.forward(u).data))
    ok["backward"] = same_bits(torch, b.data, plan.backward(f).data)
    log(f"[engine] {model.shape[0]}^3: step_async, forward_async, "
        f"backward_async against the synchronous calls, bit for bit: {ok}; "
        f"dispatch log {cert}")
    if not all(ok.values()):
        raise AssertionError(f"[engine] async calls differ: {ok}")
    if cert["verified_traces"] != 2 or cert["wire_checked"] != 2:
        raise AssertionError(f"[engine] the FFT dispatches were not "
                             f"certified: {cert}")
    return dict(bit_identical=ok, certificate=cert)


def graph_pool_bytes(torch, handle) -> int:
    """Bytes of the device segments in the CUDA graph memory pool
    ``handle`` (None: 0), as the caching allocator's snapshot lists
    them."""
    if handle is None:
        return 0
    return sum(s["total_size"] for s in torch.cuda.memory._snapshot()[
        "segments"] if tuple(s.get("segment_pool_id") or ()) == tuple(handle))


def compiled_plan_check(torch, pat, model, k1, acc, calls=20):
    """Phase 5d (c): ``compile()`` of the NS plan (batch 3) as one CUDA
    graph per direction: forward and backward bit-identical to the eager
    chain; every call one replay and no K1 launch through the wrapper (no
    eager chain ran); the graph's pool bytes and the K1 launches captured
    in it; median ms over ``calls`` calls of eager against compiled, and
    the input copy, the replay and the output copy timed apart.  The
    pool's bytes after each direction's capture are read here, from the
    allocator's snapshot: both directions share the plan's one pool."""
    from pencilarrays_tpu_torch.models import taylor_green

    plan = model.plan
    u = model.to_physical(taylor_green(model))
    c = plan.compile()
    if c is not plan.compile() or not c.graphed:
        raise AssertionError("[compiled] compile() is not cached, or not a "
                             "CUDA graph on the card")
    f = _io_counted(torch, k1, acc, lambda: c.forward(u))[0]
    pool_fwd = graph_pool_bytes(torch, c.pool_handle)
    b = _io_counted(torch, k1, acc, lambda: c.backward(f))[0]
    pool_both = graph_pool_bytes(torch, c.pool_handle)
    ef, eb = plan.forward(u), plan.backward(f)
    ok = dict(forward=same_bits(torch, f.data, ef.data),
              backward=same_bits(torch, b.data, eb.data))
    info = {d: c.graph_info(d) for d in ("forward", "backward")}
    info["forward"]["pool_total_bytes"] = pool_fwd
    info["backward"]["pool_total_bytes"] = pool_both
    if not all(ok.values()):
        raise AssertionError(f"[compiled] differs from the eager chain: {ok}")

    def timed(fn):
        out = []
        for _ in range(calls):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            out.append(s.elapsed_time(e))
        return _median(out)

    graph, static, res, _, _ = c._graphs["forward"]
    replays0, n0 = c.replays, k1.launches
    r = dict(bit_identical=ok, graphs=info,
             eager_fwd_ms=timed(lambda: plan.forward(u)),
             compiled_fwd_ms=timed(lambda: c.forward(u)),
             eager_bwd_ms=timed(lambda: plan.backward(f)),
             compiled_bwd_ms=timed(lambda: c.backward(f)),
             copy_in_ms=timed(lambda: static.copy_(u.data)),
             replay_ms=timed(graph.replay),
             copy_out_ms=timed(res.clone))
    eager_launches = k1.launches - n0
    replays = c.replays - replays0
    r.update(replays=replays, calls=2 * calls)
    log(f"[compiled] {model.shape[0]}^3 NS plan (batch 3) as CUDA graphs: "
        f"bit-identical to the eager chain {ok}; graphs {info}; " +
        json.dumps({k: v for k, v in r.items() if k.endswith("_ms")}) +
        f"; {replays} replays for {2 * calls} compiled calls")
    # the eager calls timed beside launch K1 through the wrapper; the
    # compiled calls replay and launch nothing through it
    want_eager = calls * (info["forward"]["k1_launches"]
                          + info["backward"]["k1_launches"])
    if replays != 2 * calls or eager_launches != want_eager:
        raise AssertionError(f"[compiled] {replays} replays for {2 * calls} "
                             f"calls, {eager_launches} K1 launches through "
                             f"the wrapper (the eager calls' own: "
                             f"{want_eager})")
    del u, f, b, ef, eb
    torch.cuda.empty_cache()
    return r


def engine_obs_check(torch, models, k1, resilience, engine, obs, model, d,
                     steps=8):
    """Phase 5d (d): with observability off and then on
    (``PENCILARRAYS_TPU_OBS`` naming a journal directory), ``steps`` steps
    of ``run_async`` timed to the device's end (ms a step), then with obs
    on ``steps`` steps with one save: the journal lints clean with the
    port's ``lint_journal`` and holds the ``ckpt.save`` records, the
    snapshot the engine's gauges."""
    dt = 5e-3
    uh0 = models.taylor_green(model)
    jdir = os.path.join(d, "obs")

    def loop(name, **kw):
        eng = engine.Engine(name)
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.run_async(uh0, dt, steps, engine=eng, **kw).result(600)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3 / steps
        finally:
            eng.close()

    out = {"off": loop("chip-obs-off")}
    os.environ["PENCILARRAYS_TPU_OBS"] = jdir
    try:
        out["on"] = loop("chip-obs-on")
        mgr = resilience.CheckpointManager(os.path.join(d, "obs-ckpt"),
                                           keep=1)
        loop("chip-obs-save", checkpoint=mgr, checkpoint_every=steps)
        gauges = obs.snapshot()["gauges"]
        obs.write_snapshot()
    finally:
        os.environ.pop("PENCILARRAYS_TPU_OBS", None)
    recs = obs.read_journal(jdir)
    errors = obs.lint_journal(jdir)
    saves = [e for e in recs if e["ev"] == "ckpt.save"]
    engine_gauges = sorted(k for k in gauges if k.startswith("engine."))
    r = dict(steps=steps, step_ms_obs_off=out["off"],
             step_ms_obs_on=out["on"], records=len(recs),
             lint_errors=len(errors), ckpt_save=[e["status"] for e in saves],
             engine_gauges=engine_gauges,
             events=sorted({e["ev"] for e in recs}))
    log(f"[obs] {steps} steps of run_async: {out['off']:.2f} ms a step with "
        f"obs off, {out['on']:.2f} with it on; then {steps} steps and one "
        f"save: journal {len(recs)} records, lint errors {errors[:3]}, "
        f"ckpt.save {r['ckpt_save']}, events {r['events']}, engine gauges "
        f"{engine_gauges}")
    if errors:
        raise AssertionError(f"[obs] the journal does not lint: {errors[:3]}")
    if r["ckpt_save"] != ["begin", "committed"] or not engine_gauges:
        raise AssertionError(f"[obs] ckpt.save {r['ckpt_save']}, engine "
                             f"gauges {engine_gauges}")
    return r


def benchtime_check(torch, pat, k1, tr, cycle, n=1024):
    """Phase 5d (e): ``utils/benchtime.device_seconds_per_iter`` on phase
    3's ``AllToAll()`` cycle (CUDA events, K = 1 and 4, the min over 3
    repeats), beside phase 3's timed cycle, with ``last_spread()``; and
    ``Auto(mode="measure")`` on one card, which resolves every hop (a
    size-1 axis) to ``AllToAll`` without measuring."""
    from pencilarrays_tpu_torch.utils import benchtime

    topo = pat.Topology((1, 1))
    shape = (n, n, n)
    px = pat.Pencil(topo, shape, (1, 2), permutation=pat.Permutation(1, 2, 0))
    py = pat.Pencil(topo, shape, (0, 2), permutation=pat.Permutation(0, 2, 1))
    pz = pat.Pencil(topo, shape, (0, 1))
    chain = [(px, py), (py, pz), (pz, py), (py, px)]

    def cycle_once(data):
        for a, b in chain:
            data = tr._hop(data, a, b, 0, pat.AllToAll())
        return data

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    x0 = torch.randn(shape, generator=gen, device="cuda")
    secs = benchtime.device_seconds_per_iter(cycle_once, x0, k0=1, k1=4,
                                             repeats=3)
    spread = benchtime.last_spread()
    reports = len(tr.last_measure_reports())
    auto = {f"{a.decomposition}->{b.decomposition}": repr(tr.resolve_method(
        a, b, (), torch.float32, pat.Auto(mode="measure"))) for a, b in chain}
    measured = len(tr.last_measure_reports()) - reports
    r = dict(cycle_ms=secs * 1e3, spread=spread,
             phase3_cycle_ms=cycle["cycle"]["ms"], auto_measure=auto,
             measured=measured)
    log(f"[benchtime] {n}^3 AllToAll cycle: device_seconds_per_iter "
        f"{secs * 1e3:.3f} ms (spread {spread}) against phase 3's "
        f"{cycle['cycle']['ms']:.3f} ms; Auto(mode='measure') on one card: "
        f"{auto}, {measured} measurements (a size-1 axis is not measured)")
    if measured or set(auto.values()) != {repr(pat.AllToAll())}:
        raise AssertionError(f"[benchtime] Auto(measure) on a size-1 axis: "
                             f"{auto}, {measured} measurements")
    del x0
    torch.cuda.empty_cache()
    return r


def phase_engine(torch, pat, models, k1, tr, cycle, ns, n=512, steps=16,
                 every=8):
    """Phase 5d: the engine on the card, in ``ENGINE_DIR`` of the checkout
    (which must hold three times the bytes the phase writes; deleted at
    the end): (a) ``engine_ns_check``, (b) ``engine_async_calls_check``,
    (c) ``compiled_plan_check``, (d) ``engine_obs_check``, (e)
    ``benchtime_check``.  K1's launches count under the paths
    ``engine_ns`` (the async loop and the async calls) and
    ``compiled_plan`` (the launches captured into the graphs)."""
    import shutil

    from pencilarrays_tpu_torch import analysis, engine, obs, resilience

    t0 = time.perf_counter()
    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), ENGINE_DIR)
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    acc = {p: dict(launches=0, recorded={}, launches_by_instance={
        i: 0 for i in k1.INSTANCES}) for p in ("engine_ns", "compiled_plan")}
    try:
        usage = shutil.disk_usage(d)
        state = 3 * n * n * (n // 2 + 1) * 8
        writes = (2 * steps // every + 2) * state
        log(f"[engine] {d}: disk_usage free {usage.free} bytes; the phase "
            f"writes {writes} bytes")
        if usage.free < 3 * writes:
            raise AssertionError(
                f"[engine] {d} has {usage.free} bytes free, under three "
                f"times the {writes} bytes phase 5d writes")
        model, ns_r = engine_ns_check(torch, pat, models, k1, resilience,
                                      engine, analysis, d, acc["engine_ns"],
                                      n, steps, every)
        r = dict(ns=ns_r, phase5_step_ms=ns["step_ms"])
        r["async_calls"] = engine_async_calls_check(
            torch, pat, model, k1, engine, analysis, acc["engine_ns"])
        r["compiled"] = compiled_plan_check(torch, pat, model, k1,
                                            acc["compiled_plan"])
        r["obs"] = engine_obs_check(torch, models, k1, resilience, engine,
                                    obs, model, d)
        del model
        torch.backends.cuda.cufft_plan_cache.clear()
        torch.cuda.empty_cache()
        r["benchtime"] = benchtime_check(torch, pat, k1, tr, cycle)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    r["paths"] = acc
    r["seconds"] = time.perf_counter() - t0
    log(f"[engine] phase 5d took {r['seconds']:.1f} s; median step in the "
        f"async loop {ns_r['async_step_ms']:.2f} ms beside phase 5's "
        f"{[round(t, 2) for t in ns['step_ms']]}; K1 launches: engine_ns "
        f"{acc['engine_ns']['launches']} "
        f"{acc['engine_ns']['launches_by_instance']}, compiled_plan "
        f"{acc['compiled_plan']['launches']}")
    for p, a in acc.items():
        if a["launches"] <= 0:
            raise AssertionError(f"the {p} path launched K1 no time")
    return r


# -- phase 5e: the runtime guard and the rest of obs/ ------------------------

GUARD_DIR = "chip_smoke_guard"


def _gib(b):
    return b / 2 ** 30


def _arm(guard, mode, d):
    if mode == "on":
        guard.enable(os.path.join(d, "bundles"))
    else:
        guard.disable()


def _guard_acc(k1):
    return dict(launches=0, recorded={},
                launches_by_instance={i: 0 for i in k1.INSTANCES})


def _cycle_pencils(pat, n):
    """Phase 3's cycle: its pencils and its seeded 1024^3 f32 field."""
    topo = pat.Topology((1, 1))
    shape = (n, n, n)
    px = pat.Pencil(topo, shape, (1, 2), permutation=pat.Permutation(1, 2, 0))
    py = pat.Pencil(topo, shape, (0, 2), permutation=pat.Permutation(0, 2, 1))
    pz = pat.Pencil(topo, shape, (0, 1))
    return px, [py, pz, py, px]


def guard_cycle_check(torch, pat, k1, guard, obs, cycle, d, acc,
                      n=1024, reps=3):
    """Phase 5e (a): the 1024^3 f32 x->y->z->y->x cycle under
    ``AllToAll()`` and ``Ring()`` with the guard on: every hop's bits
    equal the unguarded hop's (phase 3's cycle, recomputed here from the
    same seed), K1's launches by instance and bytes equal phase 3's, one
    ``guard.checks{outcome="ok"}`` per hop, the guarded cycle's peak at
    most 0.5 GiB above the unguarded one's, and ms (median of ``reps``,
    turns alternating) each way.  K1's launches of the counted guarded
    cycles count under the path ``guard_cycle``."""
    px, chain = _cycle_pencils(pat, n)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    x = pat.PencilArray(px, torch.randn(px.size_global(), generator=gen,
                                        device="cuda"))
    out = {}
    for run, method in (("cycle", pat.AllToAll()), ("cycle_ring",
                                                     pat.Ring())):
        def go():
            v = x
            for pen in chain:
                v = pat.transpose(v, pen, method=method)
            return v

        guard.disable()
        ref, v = [], x
        for pen in chain:
            v = pat.transpose(v, pen, method=method)
            ref.append(v.data)
        guard.enable(os.path.join(d, "bundles"))
        v = x
        for i, pen in enumerate(chain):
            v = pat.transpose(v, pen, method=method)
            if not same_bits(torch, v.data, ref[i]):
                raise AssertionError(f"[guard] {run}: guarded hop {i + 1} "
                                     f"differs from the unguarded hop")
        del v, ref
        obs.enable(os.path.join(d, "obs-cycle"))
        obs.registry.reset()
        (back, _) = _io_counted(torch, k1, acc, go)
        bytes_guarded = k1.bytes_moved
        by_inst = dict(k1.launches_by_instance)
        checks = obs.snapshot()["counters"]
        obs.disable()
        ok = checks.get("guard.checks{outcome=ok}", 0)
        if not same_bits(torch, back.data, x.data):
            raise AssertionError(f"[guard] {run}: round trip not "
                                 f"bit-identical")
        del back
        want = cycle[run]
        if (by_inst != want["launches_by_instance"]
                or bytes_guarded != want["k1_bytes"] or ok != len(chain)):
            raise AssertionError(
                f"[guard] {run}: K1 by instance {by_inst} (phase 3 "
                f"{want['launches_by_instance']}), bytes {bytes_guarded} "
                f"(phase 3 {want['k1_bytes']}), guard.checks ok {ok} "
                f"(hops {len(chain)})")
        peaks = {}
        for mode in ("off", "on"):
            _arm(guard, mode, d)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            go()
            torch.cuda.synchronize()
            peaks[mode] = torch.cuda.max_memory_allocated() - base
        ms = {"off": [], "on": []}
        for i in range(2 * reps):
            mode = ("off", "on", "on", "off")[i % 4]
            _arm(guard, mode, d)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            go()
            torch.cuda.synchronize()
            ms[mode].append((time.perf_counter() - t0) * 1e3)
        # the host sync: the guarded hop returns once its probes are
        # fetched, the unguarded one once its kernels are enqueued
        host = {}
        for mode in ("off", "on"):
            _arm(guard, mode, d)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            go()
            host[mode] = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
        guard.disable()
        r = dict(ms_off=_median(ms["off"]), ms_on=_median(ms["on"]),
                 ms_all=ms, peak_off=peaks["off"], peak_on=peaks["on"],
                 host_return_ms=host, k1_bytes=bytes_guarded,
                 launches_by_instance=by_inst, checks_ok=ok)
        log(f"[guard] {run} {method!r} {n}^3 f32 guarded: every hop = the "
            f"unguarded hop's bits; K1 by instance {by_inst} and bytes "
            f"{bytes_guarded} = phase 3's; guard.checks ok {ok}; ms median "
            f"of {reps}: guarded {r['ms_on']:.2f}, unguarded "
            f"{r['ms_off']:.2f} (all {ms}); peak above the input guarded "
            f"{_gib(peaks['on']):.3f} GiB, unguarded "
            f"{_gib(peaks['off']):.3f}; the call returns to the host after "
            f"{host['on']:.2f} ms guarded (each hop waits for its probes), "
            f"{host['off']:.2f} ms unguarded (enqueue)")
        if peaks["on"] - peaks["off"] > 2 ** 29:
            raise AssertionError(
                f"[guard] {run}: guarded peak {peaks['on']} more than 0.5 "
                f"GiB above the unguarded {peaks['off']}")
        out[run] = r
    del x
    torch.cuda.empty_cache()
    return out


def guard_wire_check(torch, pat, guard, obs, d, n=1024):
    """Phase 5e (b): the ``AllToAll(wire_dtype="bf16")`` cycle guarded
    passes its probes (the wire's tolerance); its first hop, on a
    constant field 1 + 2^-9 (whose bf16 rounding all goes one way, so the
    content sum drifts by 2e-3 of itself), under a wire-rtol override far
    below that raises ``WirePrecisionError`` with a ``guard.sdc`` record
    (``kind="wire"``) and a bundle.  On random data the rounding is
    unbiased: at 1024^3 its sum drift (~1e-7 relative) stays inside the
    float32 accumulator's own tolerance, ``eps * (8 + 4 log2 n)``."""
    px, chain = _cycle_pencils(pat, n)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    x = pat.PencilArray(px, torch.randn(px.size_global(), generator=gen,
                                        device="cuda"))
    m = pat.AllToAll(wire_dtype="bf16")
    guard.enable(os.path.join(d, "bundles"))
    jdir = os.path.join(d, "obs-wire")
    obs.enable(jdir)
    try:
        v = x
        for pen in chain:
            v = pat.transpose(v, pen, method=m)
        err = float((v.data - x.data).abs().max())
        del v
        x.data.fill_(1 + 2 ** -9)
        pat.transpose(x, chain[0], method=m)    # within the wire's model
        os.environ["PENCILARRAYS_TPU_GUARD_WIRE_RTOL"] = "1e-9"
        try:
            pat.transpose(x, chain[0], method=m)
            raise AssertionError("[guard] the wired hop under a 1e-9 "
                                 "wire-rtol override did not raise")
        except guard.WirePrecisionError as e:
            caught = e
        finally:
            os.environ.pop("PENCILARRAYS_TPU_GUARD_WIRE_RTOL", None)
    finally:
        obs.disable()
        guard.disable()
    sdc = [e for e in obs.read_journal(jdir) if e["ev"] == "guard.sdc"]
    if ([e["kind"] for e in sdc] != ["wire"] or caught.kind != "wire"
            or not caught.bundle or caught.wire_dtype != "bf16"):
        raise AssertionError(f"[guard] wire drill: records {sdc}, error "
                             f"{caught!r}")
    log(f"[guard] bf16 wired cycle {n}^3 guarded: probes pass, round trip "
        f"max|err| {err:.3e}; a hop of the constant field 1 + 2^-9 passes "
        f"too; under a 1e-9 wire-rtol override it "
        f"raised WirePrecisionError (kind {caught.kind}), guard.sdc "
        f"kind wire journaled, bundle {caught.bundle}")
    del x
    torch.cuda.empty_cache()
    return dict(round_trip_err=err, bundle=caught.bundle)


def _ns_hop_step(pat, model, dt):
    """One NS RK2 step followed by a hop of the state to another pencil
    and back: on one card the step itself makes no hop, and the drills
    need one (pure movement: the bits are the step's)."""
    pen = model.plan.output_pencil
    a, b = pen.decomposition
    alt = pen.replace(decomp_dims=(3 - a - b, b))

    def step(uh):
        uh = model.step(uh, dt)
        return pat.transpose(pat.transpose(uh, alt), pen)

    return step


def guard_ns_check(torch, models, k1, guard, model, d, acc,
                   steps=8, dt=5e-3):
    """Phase 5e (c): NS Taylor-Green 512^3 f32 RK2, ``steps`` steps from
    the same state with the guard off, on (the default: on one card the
    step makes no hop, so the guard only notes the plan), and on with the
    finiteness tap on every plan call (``PENCILARRAYS_TPU_GUARD_FINITE=1``):
    the final states bit-identical and K1's launches equal across the
    three; ms a step each (the second of two runs each).  The guarded
    steps with the tap count under the path ``guard_ns``."""
    uh0 = models.taylor_green(model)
    res = {}
    for mode in ("off", "on", "tap") * 2:
        if mode != "off":
            guard.enable(os.path.join(d, "bundles"))
        if mode == "tap":
            os.environ["PENCILARRAYS_TPU_GUARD_FINITE"] = "1"
        try:
            def loop():
                u = uh0
                for _ in range(steps):
                    u = model.step(u, dt)
                return u

            if mode == "tap" and mode in res:
                uh, secs = _io_counted(torch, k1, acc, loop)
                launches = acc["launches"]
            else:
                _reset_k1(k1)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                uh = loop()
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                launches = k1.launches
        finally:
            guard.disable()
            os.environ.pop("PENCILARRAYS_TPU_GUARD_FINITE", None)
        res.setdefault(mode, []).append((uh, secs * 1e3 / steps, launches))
    # the second run of each mode: warm (first runs warm cuFFT and K1)
    ref, ms_off, l_off = res["off"][1]
    out = dict(step_ms_off=ms_off, k1_launches=l_off, steps=steps)
    for mode in ("on", "tap"):
        u, ms, n_k1 = res[mode][1]
        if not same_bits(torch, u.data, ref.data) or n_k1 != l_off:
            raise AssertionError(
                f"[guard] NS steps guarded ({mode}) against unguarded: "
                f"bits equal {same_bits(torch, u.data, ref.data)}, K1 "
                f"launches {n_k1} and {l_off}")
        out[f"step_ms_{mode}"] = ms
    log(f"[guard] NS {model.plan.shape_physical} f32 {steps} RK2 steps: "
        f"guarded = unguarded bits, K1 launches {l_off} each way; ms a "
        f"step unguarded {ms_off:.2f}, guarded {out['step_ms_on']:.2f}, "
        f"guarded with the finiteness tap on every plan call "
        f"{out['step_ms_tap']:.2f} (first runs "
        f"{[round(res[m][0][1], 2) for m in ('off', 'on', 'tap')]})")
    return out


def guard_drills(torch, pat, models, k1, guard, gi, obs, resilience,
                 model, d, acc, n=1024, dt=5e-3):
    """Phase 5e (d), each drill raising its typed error: (1)
    ``hop.exchange:corrupt`` on a 1024^3 hop, guard on: ``IntegrityError``,
    ``guard.sdc`` journaled, a bundle whose plans hold the NS plan's
    fingerprint; guard off, the poke lands on the JAX package's element
    (flat index ``hit - 1`` of the output) and flows through; (2)
    ``ckpt.restore:corrupt`` on the 512^3 NS state: one element poked,
    caught by the guard's finiteness boundary check; (3)
    ``guarded_step`` over NS steps with a hop each, a
    ``CheckpointManager`` save at step 2: a corrupt hop at step 3
    survived by retry, one at step 5 by escalating to the restore of step
    2, the final state = the uninterrupted run's bits; (4)
    ``hop.exchange:delay`` past a short watchdog deadline:
    ``HangTimeoutError`` with a bundle.  K1's launches count under the
    path ``guard_drills``."""
    faults = resilience.faults
    px, chain = _cycle_pencils(pat, n)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    x = pat.PencilArray(px, torch.randn(px.size_global(), generator=gen,
                                        device="cuda"))
    jdir = os.path.join(d, "obs-drills")
    out = {}
    obs.enable(jdir)
    guard.enable(os.path.join(d, "bundles"))
    try:
        # (1) the corrupt hop, guarded
        def corrupt_hop():
            try:
                pat.transpose(x, chain[0])
            except guard.IntegrityError as e:
                return e
            return None

        with faults.active("hop.exchange:corrupt"):
            err, _ = _io_counted(torch, k1, acc, corrupt_hop)
        if err is None:
            raise AssertionError("[guard] the corrupt hop did not raise")
        with open(os.path.join(err.bundle, "plans.json")) as f:
            kinds = sorted({p["kind"] for p in json.load(f)})
        if err.kind != "sum" or "fft_plan" not in kinds:
            raise AssertionError(f"[guard] corrupt drill: {err!r}, bundle "
                                 f"plans {kinds}")
        # (1) unguarded: the poke flows through at JAX's element
        guard.disable()
        ref = pat.transpose(x, chain[0]).data
        with faults.active("hop.exchange:corrupt@2"):
            pat.transpose(x, chain[0])
            poked = pat.transpose(x, chain[0]).data
        flat, rflat = poked.reshape(-1), ref.reshape(-1)
        nan_at = torch.nonzero(torch.isnan(flat)).reshape(-1).tolist()
        same_rest = torch.equal(flat[2:], rflat[2:]) and torch.equal(
            flat[:1], rflat[:1])
        del ref, poked, flat, rflat
        if nan_at != [1] or not same_rest:
            raise AssertionError(f"[guard] unguarded poke at {nan_at}, "
                                 f"rest equal {same_rest} (want [1])")
        out["corrupt_hop"] = dict(kind=err.kind, bundle=err.bundle,
                                  plans=kinds, unguarded_nan_at=nan_at)
        log(f"[guard] hop.exchange:corrupt {n}^3: guarded IntegrityError "
            f"(kind {err.kind}), bundle {err.bundle} with plans {kinds}; "
            f"unguarded, hit 2 poked flat index {nan_at} (= hit - 1, the "
            f"JAX package's element) and nothing else")
        del x
        torch.cuda.empty_cache()
        guard.enable(os.path.join(d, "bundles"))

        # (2) the corrupt restore
        pen = model.plan.output_pencil
        uh0 = models.taylor_green(model)
        mgr = resilience.CheckpointManager(os.path.join(d, "ck"), keep=2)
        mgr.save(0, {"uh": uh0})
        with faults.active("ckpt.restore:corrupt"):
            back = mgr.restore(0).read("uh", pen)
        bad = torch.nonzero(back.data.reshape(-1) != uh0.data.reshape(-1))
        try:
            gi.check_finite_boundary("ckpt.restore", uh0.data, back.data)
            raise AssertionError("[guard] the corrupt restore was not "
                                 "caught")
        except guard.IntegrityError as e:
            rerr = e
        if bad.reshape(-1).tolist() != [0] or rerr.kind != "nonfinite":
            raise AssertionError(f"[guard] restore drill: differs at "
                                 f"{bad.reshape(-1).tolist()}, {rerr!r}")
        del back
        out["corrupt_restore"] = dict(kind=rerr.kind, bundle=rerr.bundle)
        log(f"[guard] ckpt.restore:corrupt on the {model.plan.shape_physical} "
            f"NS state: element "
            f"0 poked (NaN), caught by the finiteness boundary check: "
            f"IntegrityError (kind {rerr.kind}), bundle {rerr.bundle}")

        # (3) guarded_step: retry, then escalation to a restore
        step = _ns_hop_step(pat, model, dt)
        ref = uh0
        for _ in range(6):
            ref = step(ref)
        state = {"uh": uh0, "k": 0}
        mgr2 = resilience.CheckpointManager(os.path.join(d, "ck2"), keep=1)

        def restore(ckpt):
            state["uh"] = ckpt.read("uh", pen)
            state["k"] = ckpt.step

        policy = resilience.RetryPolicy(max_attempts=2, base_delay=0.01)
        drill = {3: "hop.exchange:corrupt*1", 5: "hop.exchange:corrupt*2"}

        def run_step():
            state["uh"] = guard.guarded_step(
                lambda: step(state["uh"]), ckpt_mgr=mgr2, restore=restore,
                retry=policy, label="ns-guarded")
            state["k"] += 1
            if state["k"] == 2:
                mgr2.save(2, {"uh": state["uh"]})

        def ladder():
            while state["k"] < 6:
                spec = drill.pop(state["k"] + 1, None)
                if spec is None:
                    run_step()
                else:
                    with faults.active(spec):
                        run_step()

        _io_counted(torch, k1, acc, ladder)
        stages = [(e["label"], e["stage"]) for e in obs.read_journal(jdir)
                  if e["ev"] == "guard.recover"]
        want = [("ns-guarded", s) for s in (
            "error", "retry", "recovered", "error", "retry", "error",
            "restore", "recovered")]
        if not same_bits(torch, state["uh"].data, ref.data) or \
                stages != want:
            raise AssertionError(f"[guard] guarded_step ladder: final = "
                                 f"uninterrupted "
                                 f"{same_bits(torch, state['uh'].data, ref.data)}"
                                 f", stages {stages}")
        out["guarded_step"] = dict(stages=[s for _, s in stages])
        log(f"[guard] guarded_step over 6 NS steps with a hop each: a "
            f"corrupt hop at step 3 survived by retry, at step 5 by "
            f"restoring step 2; stages {[s for _, s in stages]}; final "
            f"state = the uninterrupted run's bits")
        del ref, state, uh0

        # (4) the hang drill
        os.environ[faults.DELAY_S_VAR] = "3"
        os.environ["PENCILARRAYS_TPU_GUARD_TIMEOUT"] = "0.5"
        small = pat.Pencil(pat.Topology((1, 1)), (64, 64, 64), (1, 2))
        y = pat.PencilArray.zeros(small, dtype=torch.float32)
        t0 = time.perf_counter()
        try:
            with faults.active("hop.exchange:delay"):
                guard.guarded_step(lambda: pat.transpose(
                    y, small.replace(decomp_dims=(0, 2))), label="hang")
            raise AssertionError("[guard] the delayed hop did not time out")
        except guard.HangTimeoutError as e:
            herr = e
        finally:
            os.environ.pop(faults.DELAY_S_VAR, None)
            os.environ.pop("PENCILARRAYS_TPU_GUARD_TIMEOUT", None)
        secs = time.perf_counter() - t0
        if not herr.bundle or secs > 2.5:
            raise AssertionError(f"[guard] hang drill: {herr!r} after "
                                 f"{secs:.2f} s")
        out["hang"] = dict(seconds=secs, bundle=herr.bundle)
        log(f"[guard] hop.exchange:delay 3 s past a 0.5 s watchdog: "
            f"HangTimeoutError after {secs:.2f} s, bundle {herr.bundle}")
    finally:
        guard.disable()
        obs.disable()
    errors = obs.lint_journal(jdir)
    if errors:
        raise AssertionError(f"[guard] drill journal lint: {errors[:3]}")
    return out


def obs_rest_check(torch, pat, k1, routing, obs, engine, models, model,
                   d, acc, n=1024, dt=5e-3):
    """Phase 5e (e): the rest of obs/ on the card.  ``measure_transpose``
    of the 1024^3 cycle's hops (``benchtime`` samples), the drift report
    with its fitted bandwidth per source class; a 1024^3 reshard route
    planned with trusted drift in the one-process world (a
    ``route.plan`` record); ``merge_journals`` and ``write_trace`` on the
    phase's journal and ``python -m pencilarrays_tpu_torch.obs`` ``lint``,
    ``merge`` and ``trace`` on it (exit 0); ``reconstruct_request`` of one
    ``run_async`` dispatch that carried a trace; ``MeshAggregator`` over
    ``FileKV`` at world 1 (``mesh_metrics.json``, the Prometheus text with
    ``rank`` labels); the straggler rule on one rank (skipped, as the
    JAX package's).  K1's launches count under the path ``obs_rest``."""
    from pencilarrays_tpu_torch.cluster.kv import FileKV
    from pencilarrays_tpu_torch.obs import aggregate, drift, requestflow
    from pencilarrays_tpu_torch.obs import straggler

    jdir = os.path.join(d, "obs-rest")
    obs.enable(jdir)
    drift.drift_tracker.reset()
    px, chain = _cycle_pencils(pat, n)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    x = pat.PencilArray(px, torch.randn(px.size_global(), generator=gen,
                                        device="cuda"))
    try:
        def measure():
            v, got = x, []
            for pen in chain[:2]:
                got.append(drift.measure_transpose(v, pen, k0=1, k1=4,
                                                   repeats=3))
                v = pat.transpose(v, pen)
            return got

        measured, _ = _io_counted(torch, k1, acc, measure)
        report = obs.drift_report()
        trusted = routing.trusted_drift_hops()
        pz = chain[1].replace(decomp_dims=(2, 0),
                              permutation=pat.Permutation(2, 0, 1))
        v0 = drift.drift_tracker.version()
        route = routing.plan_reshard_route(px, pz, (), torch.float32,
                                           method=pat.AllToAll())
        _io_counted(torch, k1, acc, lambda: pat.reshard(
            x, pz, method=pat.AllToAll()))
        del x
        torch.cuda.empty_cache()
        # one run_async dispatch carrying a trace (its hops journal it)
        tr_id = requestflow.mint_trace()
        step = _ns_hop_step(pat, model, dt)

        def traced(uh):
            with requestflow.installed(tr_id):
                return step(uh)

        eng = engine.Engine("chip-trace")
        try:
            uh = models.taylor_green(model)
            _io_counted(torch, k1, acc, lambda: model.run_async(
                uh, dt, 1, engine=eng,
                stepper=lambda s, _dt: traced(s)).result(600))
        finally:
            eng.close()
        snap = obs.snapshot()
        obs.write_snapshot()
        agg = aggregate.MeshAggregator(FileKV(os.path.join(d, "kv")), 0, 1,
                                       cadence=60)
        published = agg.publish_once()
        fold = agg.fold_once(wait=True, timeout=30)
    finally:
        obs.disable()
    events = obs.read_journal(jdir)
    plans = [e for e in events if e["ev"] == "route.plan"]
    tl = obs.merge_journals(jdir)
    trace = obs.write_trace(jdir, os.path.join(d, "trace.json"))
    rt, rt_warn = requestflow.reconstruct_request(jdir, tr_id)
    cli = {}
    for cmd in (["lint", jdir], ["merge", jdir, "-o",
                                 os.path.join(d, "merged.jsonl")],
                ["trace", jdir, "-o", os.path.join(d, "trace2.json")]):
        p = subprocess.run([sys.executable, "-m",
                            "pencilarrays_tpu_torch.obs"] + cmd,
                           capture_output=True, text=True, timeout=300,
                           cwd=os.path.dirname(os.path.abspath(__file__)))
        cli[cmd[0]] = p.returncode
        if p.returncode != 0:
            raise AssertionError(f"[obs] pa-obs {cmd[0]} exit "
                                 f"{p.returncode}: {p.stdout[-400:]} "
                                 f"{p.stderr[-400:]}")
    with open(os.path.join(jdir, "mesh_metrics.prom")) as f:
        prom = f.read()
    ranked = 'rank="0"' in prom
    flags = straggler.detect_from_events(events)
    scan = straggler.scan_snapshots({0: snap})
    hops = report["hops"]
    r = dict(measured=measured, fitted_bytes_per_s=report[
        "fitted_bytes_per_s"], dispatch_fitted_bytes_per_s=report[
        "dispatch_fitted_bytes_per_s"],
        drift_hops={h: {k: e[k] for k in ("source", "predicted_bytes",
                                          "measured_s", "drift")}
                    for h, e in hops.items()},
        route_verdict=route.verdict, trusted=len(trusted),
        tracker_version=v0, route_plan_events=len(plans),
        merged_events=len(tl.events), merge_warnings=tl.warnings,
        trace_events=len(trace["traceEvents"]), cli=cli,
        request_events=len(rt.events) if rt else 0,
        request_ranks=rt.ranks if rt else None,
        mesh_ranks=fold["ranks"] if fold else None,
        straggler_flags=flags, straggler_scan=scan)
    log(f"[obs] measure_transpose on {n}^3 hops: "
        f"{[(m['hop'], round(m['seconds'] * 1e3, 3)) for m in measured]} "
        f"ms; drift report: fitted bytes/s device "
        f"{report['fitted_bytes_per_s']}, dispatch "
        f"{report['dispatch_fitted_bytes_per_s']} (one card: every hop "
        f"prices 0 wire bytes, so no bandwidth is fitted); hops "
        f"{r['drift_hops']}")
    log(f"[obs] reshard route {px.decomposition}->{pz.decomposition} "
        f"planned with {len(trusted)} trusted drift hops at tracker version "
        f"{v0} (world 1): verdict {route.verdict}, {len(plans)} route.plan "
        f"record(s); merged journal {len(tl.events)} events, warnings "
        f"{tl.warnings}; Chrome trace {len(trace['traceEvents'])} events; "
        f"pa-obs lint/merge/trace exit {cli}; request {tr_id}: "
        f"{r['request_events']} events on ranks {r['request_ranks']}; "
        f"MeshAggregator over FileKV at world 1: published {published}, "
        f"mesh ranks {r['mesh_ranks']}, rank label in the text "
        f"{ranked}; straggler rule on one rank: flags "
        f"{flags}, scan {scan} (one rank: nothing to compare, skipped)")
    if not (trusted and plans and tl.events and trace["traceEvents"]
            and rt is not None and r["request_events"] > 0
            and fold and fold["ranks"] == [0] and ranked
            and published and not flags and not scan
            and all(e["source"] == "benchtime" for h, e in hops.items()
                    if any(h == m["hop"] for m in measured))):
        raise AssertionError(f"[obs] the rest of obs/: {r}")
    errors = obs.lint_journal(jdir)
    if errors:
        raise AssertionError(f"[obs] journal lint: {errors[:3]}")
    return r


def phase_guard(torch, pat, models, k1, cycle, n=1024, n_ns=512):
    """Phase 5e: the runtime guard and the rest of obs/, in ``GUARD_DIR``
    of the checkout (deleted at the end): (a) ``guard_cycle_check``, (b)
    ``guard_wire_check``, (c) ``guard_ns_check``, (d) ``guard_drills``,
    (e) ``obs_rest_check``.  K1's launches count under the paths
    ``guard_cycle``, ``guard_ns``, ``guard_drills`` and ``obs_rest``."""
    import shutil

    from pencilarrays_tpu_torch import engine, guard, obs, resilience
    from pencilarrays_tpu_torch.guard import integrity as gi
    from pencilarrays_tpu_torch.parallel import routing

    t0 = time.perf_counter()
    # earlier phases' engines and futures hold device tensors in reference
    # cycles: collect them before the phase's 512^3 steps need the room
    held = torch.cuda.memory_allocated()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[guard] device memory allocated at the phase's start "
        f"{_gib(held):.2f} GiB, {_gib(torch.cuda.memory_allocated()):.2f} "
        f"after collecting garbage")
    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), GUARD_DIR)
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    acc = {p: _guard_acc(k1) for p in ("guard_cycle", "guard_ns",
                                       "guard_drills", "obs_rest")}
    r = {}
    try:
        r["cycle"] = guard_cycle_check(torch, pat, k1, guard, obs, cycle,
                                       d, acc["guard_cycle"], n)
        r["wire"] = guard_wire_check(torch, pat, guard, obs, d, n)
        guard.enable(os.path.join(d, "bundles"))
        model = models.NavierStokesSpectral(pat.Topology((1, 1)), n_ns,
                                            viscosity=1e-2,
                                            dtype=torch.float32)
        guard.disable()
        r["ns"] = guard_ns_check(torch, models, k1, guard, model, d,
                                 acc["guard_ns"])
        r["drills"] = guard_drills(torch, pat, models, k1, guard, gi, obs,
                                   resilience, model, d,
                                   acc["guard_drills"], n)
        r["obs"] = obs_rest_check(torch, pat, k1, routing, obs, engine,
                                  models, model, d, acc["obs_rest"], n)
        del model
        torch.backends.cuda.cufft_plan_cache.clear()
        torch.cuda.empty_cache()
    finally:
        guard.disable()
        obs.disable()
        shutil.rmtree(d, ignore_errors=True)
        # the drills' typed errors keep their tracebacks' frames (and the
        # tensors in them) in reference cycles
        gc.collect()
        torch.cuda.empty_cache()
    r["paths"] = acc
    r["seconds"] = time.perf_counter() - t0
    log(f"[guard] phase 5e took {r['seconds']:.1f} s; K1 launches: "
        + ", ".join(f"{p} {a['launches']} {a['launches_by_instance']}"
                    for p, a in acc.items())
        + f"; device memory allocated after it "
          f"{_gib(torch.cuda.memory_allocated()):.2f} GiB")
    for p, a in acc.items():
        if a["launches"] <= 0:
            raise AssertionError(f"the {p} path launched K1 no time")
    return r


CLUSTER_DIR = "chip_smoke_cluster"
CLUSTER_TTL = 2.0       # the lease ttl of the JAX package's drill workers


def _cluster_run(root, d, world, phase, n, kill=None, timeout=420,
                 device="cuda"):
    """One drill phase: ``world`` rank processes of
    ``tests/torch_cluster_worker.py`` on the card, joined by a ``FileKV``
    under ``d``; each must print its ``CLUSTER_OK`` line, the rank
    ``kill`` must die by SIGKILL.  Returns each rank's output."""
    import signal

    worker = os.path.join(root, "tests", "torch_cluster_worker.py")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("PENCILARRAYS_TPU_CLUSTER",
                                "PENCILARRAYS_TPU_FAULTS",
                                "PENCILARRAYS_TPU_ELASTIC",
                                "PENCILARRAYS_TPU_OBS",
                                "PENCILARRAYS_TPU_GUARD"))}
    env["PENCILARRAYS_TPU_CLUSTER_LEASE_TTL"] = str(CLUSTER_TTL)
    env.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    procs = [subprocess.Popen(
        [sys.executable, worker, os.path.join(d, "kv"), str(world), str(r),
         d, phase, str(n), device], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    outs = []
    t_end = time.monotonic() + timeout
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(1.0, t_end - time.monotonic()))[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs[len(outs):]:
            outs.append(p.communicate()[0] or "")
        raise AssertionError(f"[cluster] {phase} world {world} timed out:\n"
                             + "\n---\n".join(o[-3000:] for o in outs))
    for r, (p, out) in enumerate(zip(procs, outs)):
        if r == kill:
            if p.returncode != -signal.SIGKILL:
                raise AssertionError(f"[cluster] {phase}: rank {r} should "
                                     f"die by SIGKILL, rc {p.returncode}"
                                     f"\n{out[-3000:]}")
            continue
        if p.returncode != 0 or \
                f"CLUSTER_OK phase={phase} rank={r}" not in out:
            raise AssertionError(f"[cluster] {phase} rank {r} failed, rc "
                                 f"{p.returncode}:\n{out[-3000:]}")
    return outs


def _tuples(x):
    return tuple(_tuples(i) for i in x) if isinstance(x, list) else x


def _cluster_k1(outs, acc):
    """Add the K1 launches each rank reported (``K1=<n> {...}``) and the
    classes it launched (``K1_CLASSES=[[class, count], ...]``)."""
    for out in outs:
        m = re.search(r"^K1=(\d+) (\{.*\})$", out, re.M)
        if m:
            acc["launches"] += int(m.group(1))
            for inst, c in json.loads(m.group(2)).items():
                acc["launches_by_instance"][inst] = \
                    acc["launches_by_instance"].get(inst, 0) + c
        m = re.search(r"^K1_CLASSES=(\[.*\])$", out, re.M)
        if m:
            for cls, c in json.loads(m.group(1)):
                cls = _tuples(cls)
                acc["recorded"][cls] = acc["recorded"].get(cls, 0) + c


def _cluster_elastic(root, d, world, n, acc, device):
    """``elastic_ref`` then ``elastic`` at ``world`` ranks and n^3: every
    survivor's digest equals the uninterrupted run's; the reformation's
    report of each survivor."""
    ref_d, el_d = os.path.join(d, f"ref{world}"), os.path.join(d, f"el{world}")
    os.makedirs(ref_d)
    os.makedirs(el_d)
    t0 = time.perf_counter()
    outs = _cluster_run(root, ref_d, world, "elastic_ref", n, device=device)
    ref_s = time.perf_counter() - t0
    _cluster_k1(outs, acc)
    finals = {re.search(r"FINAL=([0-9a-f]{64})", o).group(1) for o in outs}
    if len(finals) != 1:
        raise AssertionError(f"[cluster] elastic_ref digests differ: "
                             f"{finals}")
    shutil.rmtree(ref_d, ignore_errors=True)
    t0 = time.perf_counter()
    outs = _cluster_run(root, el_d, world, "elastic", n, kill=world - 1,
                        device=device)
    el_s = time.perf_counter() - t0
    _cluster_k1(outs, acc)
    reports = []
    for r, out in enumerate(outs[:-1]):
        if "SERVE_RESUMED=2" not in out:
            raise AssertionError(f"[cluster] elastic rank {r}: the served "
                                 f"plan's requests did not drain after the "
                                 f"reformation\n{out[-2000:]}")
        m = re.search(r"FINAL=([0-9a-f]{64})", out)
        if not m or m.group(1) not in finals:
            raise AssertionError(f"[cluster] elastic rank {r}: digest "
                                 f"differs from the uninterrupted run's\n"
                                 f"{out[-2000:]}")
        rep = json.loads(re.search(r"^REFORMED (\{.*\})$", out,
                                   re.M).group(1))
        if rep["world"] != world - 1 or rep["restored_step"] != 2 or \
                rep["members"] != list(range(world - 1)):
            raise AssertionError(f"[cluster] elastic rank {r}: {rep}")
        rep["step_ms"] = json.loads(re.search(r"^STEP_MS=(.*)$", out,
                                              re.M).group(1))
        reports.append(rep)
    shutil.rmtree(el_d, ignore_errors=True)
    r = dict(world=world, n=n, final=finals.pop(), ref_s=ref_s,
             elastic_s=el_s, survivors=reports)
    log(f"[cluster] elastic world {world} -> {world - 1} at {n}^3: digest "
        f"= the uninterrupted run's; " + json.dumps(r))
    return r


def _cluster_storm(root, d, n, acc, device):
    """``storm`` at world 2 and n^3: 4 sheddable reshards shed typed, rank
    1 killed inside the storm batch, the survivor's serve dispatch reforms
    and drains its 4 protected tickets bit-identical to ``reshard``."""
    sd = os.path.join(d, "storm")
    os.makedirs(sd)
    t0 = time.perf_counter()
    outs = _cluster_run(root, sd, 2, "storm", n, kill=1, device=device)
    _cluster_k1(outs, acc)
    if "STORM_SHED=4" not in outs[0]:
        raise AssertionError(f"[cluster] storm: {outs[0][-2000:]}")
    rep = json.loads(re.search(r"^STORM_OK=(\{.*\})$", outs[0],
                               re.M).group(1))
    rep["seconds"] = time.perf_counter() - t0
    shutil.rmtree(sd, ignore_errors=True)
    log(f"[cluster] storm world 2 -> 1 at {n}^3: 4 sheddable reshards shed "
        f"at submit, rank 1 killed in the storm batch, 4 protected served "
        f"bit-identical after the reformation; " + json.dumps(rep))
    return rep


def _cluster_scale(root, d, n, acc, device):
    """``scale`` at world 2 and n^3: idle scale-down by ``announce_leave``,
    the leaver rejoins pre-warmed, admitted by the scale-up."""
    sd = os.path.join(d, "scale")
    os.makedirs(sd)
    t0 = time.perf_counter()
    outs = _cluster_run(root, sd, 2, "scale", n, device=device)
    _cluster_k1(outs, acc)
    up = re.search(r"SCALE_UP gen=(\d+) detail=(\S+)", outs[0])
    joined = re.search(r"SCALE_JOINED gen=(\d+) rank=(\d+) warm_s=([0-9.]+)",
                       outs[1])
    if "SCALE_DOWN world=1" not in outs[0] or not up or not joined:
        raise AssertionError(f"[cluster] scale: {outs[0][-1500:]}\n---\n"
                             f"{outs[1][-1500:]}")
    rep = dict(up_gen=int(up.group(1)), detail=up.group(2),
               joined_rank=int(joined.group(2)),
               warm_s=float(joined.group(3)),
               seconds=time.perf_counter() - t0)
    shutil.rmtree(sd, ignore_errors=True)
    log(f"[cluster] scale at {n}^3: world 2 -> 1 (idle, announce_leave) -> "
        f"2 (pre-warmed joiner admitted by the scale-up); " + json.dumps(rep))
    return rep


def phase_cluster(torch, k1, n=512, n4=256, device="cuda"):
    """Phase 5f: the cluster layer on the card, as the JAX package's
    ``cluster_worker.py`` drills (module docstring).  The rank processes
    load K1 from ``ops/_build`` (built in phase 1); their launches count
    under the path ``cluster``."""
    from pencilarrays_tpu_torch import obs

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    log(f"[cluster] device memory at the phase's start: this process "
        f"allocated {_gib(torch.cuda.memory_allocated()):.2f} GiB, reserved "
        f"{_gib(torch.cuda.memory_reserved()):.2f} GiB; free on the card "
        f"{_gib(free):.2f} of {_gib(total):.2f} GiB")
    root = os.path.dirname(os.path.abspath(__file__))
    d = os.path.join(root, CLUSTER_DIR)
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    acc = {"launches": 0, "launches_by_instance": {}, "recorded": {}}
    res = {}
    try:
        # sdc: agreed retry, then the agreed restore of step 1
        sd = os.path.join(d, "seq")
        os.makedirs(sd)
        t = time.perf_counter()
        outs = _cluster_run(root, sd, 2, "sdc", n, device=device)
        _cluster_k1(outs, acc)
        events = obs.read_journal(os.path.join(sd, "obs"))
        if obs.lint_journal(events):
            raise AssertionError(f"[cluster] sdc journal: "
                                 f"{obs.lint_journal(events)[:5]}")
        actions = {r: [e["action"] for e in events
                       if e["ev"] == "cluster.verdict" and e["proc"] == r]
                   for r in range(2)}
        restores = {r: sorted({e["step"] for e in events
                               if e["ev"] == "ckpt.restore"
                               and e["proc"] == r}) for r in range(2)}
        if any(a != ["retry", "restore", "elect", "ok"]
               for a in actions.values()) or \
                any(v != [1] for v in restores.values()):
            raise AssertionError(f"[cluster] sdc verdicts {actions}, "
                                 f"restores {restores}")
        res["sdc"] = dict(actions=actions[0], restored_step=1,
                          seconds=time.perf_counter() - t,
                          recover_s=[float(re.search(
                              r"SDC_RECOVERED step=1 s=([0-9.]+)",
                              o).group(1)) for o in outs])
        log(f"[cluster] sdc world 2 at {n}^3: every rank agreed retry, "
            "restore, elect, ok; restored step 1 bit-identical to the "
            "uninterrupted step; " + json.dumps(res["sdc"]))
        # kill: rank 0 dies mid-step, the survivor fails typed
        t = time.perf_counter()
        outs = _cluster_run(root, sd, 2, "kill", n, kill=0, device=device)
        _cluster_k1(outs, acc)
        m = re.search(r"peerfail=(\d+) detect_s=([0-9.]+)", outs[1])
        if not m or int(m.group(1)) != 0 or \
                float(m.group(2)) > 4 * CLUSTER_TTL + 5.0:
            raise AssertionError(f"[cluster] kill: survivor {outs[1][-2000:]}")
        res["kill"] = dict(peer=0, detect_s=float(m.group(2)),
                           ttl_s=CLUSTER_TTL,
                           seconds=time.perf_counter() - t)
        log(f"[cluster] kill world 2 at {n}^3: rank 0 SIGKILLed at its first "
            "exchange; rank 1 raised PeerFailureError naming it, with a "
            "crash bundle; " + json.dumps(res["kill"]))
        # restore: fresh processes elect and restore step 1
        t = time.perf_counter()
        outs = _cluster_run(root, sd, 2, "restore", n, device=device)
        _cluster_k1(outs, acc)
        res["restore"] = dict(step=1, seconds=time.perf_counter() - t)
        log(f"[cluster] restore world 2 at {n}^3: fresh processes elected "
            "step 1 and restored it bit-identical; "
            + json.dumps(res["restore"]))
        shutil.rmtree(sd, ignore_errors=True)
        res["elastic"] = _cluster_elastic(root, d, 2, n, acc, device)
        res["storm"] = _cluster_storm(root, d, n, acc, device)
        res["scale"] = _cluster_scale(root, d, n4, acc, device)
        res["elastic4"] = _cluster_elastic(root, d, 4, n4, acc, device)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    res["recorded"] = acc.pop("recorded")
    res["paths"] = {"cluster": acc}
    res["seconds"] = time.perf_counter() - t0
    log(f"[cluster] phase 5f took {res['seconds']:.1f} s; K1 launches in the "
        f"rank processes {acc['launches']} {acc['launches_by_instance']}")
    if acc["launches"] <= 0:
        raise AssertionError("the cluster path launched K1 no time")
    return res


PSVC_DIR = "chip_smoke_serve"
# A served result is held to the sequential call's bits, or within this
# share of max|ref|: on the card cuFFT's batched plan (the B = 8 batch,
# the batch dim outermost) rounds apart from its single-sample plan, by
# 2.1e-7 of max|u_hat| on an H100 (ROADMAP Queue 3).  Reshards, and
# the split and stack copies, are held to the bits: they move data.
PSVC_FFT_TOL = 1e-6


def _psvc_same(torch, got, ref, what, diffs, fft=True):
    """A served result against its sequential call: the bits, or for an
    FFT within ``PSVC_FFT_TOL`` of max|ref|; every difference is kept in
    ``diffs``."""
    if same_bits(torch, got, ref):
        return
    err = max_abs_err(torch, got, ref) / max(
        float(ref.abs().max()), 1e-30)
    diffs.append({"what": what, "rel_err": err})
    if not fft or not err <= PSVC_FFT_TOL:
        raise AssertionError(f"[plan_service] {what}: not the sequential "
                             f"call's bits (max|diff| / max|ref| {err:.3e})")


def _psvc_owned(got, shape):
    """A result owns its storage and is one sample's size."""
    t = got.data
    if tuple(t.shape) != tuple(shape) or not t.is_contiguous() or \
            t.untyped_storage().nbytes() != t.numel() * t.element_size():
        raise AssertionError(f"[plan_service] a result of shape "
                             f"{tuple(t.shape)} holds "
                             f"{t.untyped_storage().nbytes()} bytes of "
                             f"storage (one sample: {t.numel() * t.element_size()})")


def _psvc_traffic(np, pat, plan, pin, n_fft, n_resh, seed):
    """The four tenants' payloads from one numpy seed: ``a`` host
    physical fields, ``b`` host spectra, ``c`` the same kind of fields on
    the card, ``d`` fields on the card to reshard."""
    rng = np.random.default_rng(seed)

    def real():
        return rng.random(plan.shape_physical, dtype=np.float32) - 0.5

    def spec():
        x = np.empty(plan.shape_spectral, np.complex64)
        rng.random(out=x.view(np.float32), dtype=np.float32)
        return x

    a = [real() for _ in range(n_fft)]
    b = [spec() for _ in range(n_fft)]
    c = [pat.PencilArray.from_global(plan.input_pencil, real())
         for _ in range(n_fft)]
    d = [pat.PencilArray.from_global(pin, real()) for _ in range(n_resh)]
    return a, b, c, d


def _psvc_submit(svc, plan, traffic, pout, tenants="abcd"):
    """Tenant by tenant, in that order: ``a`` host forwards, ``b`` host
    backwards, ``c`` device forwards, ``d`` reshards."""
    a, b, c, d = traffic
    tickets = {}
    for t in tenants:
        if t == "a":
            tickets[t] = [svc.submit("a", u, plan=plan) for u in a]
        elif t == "b":
            tickets[t] = [svc.submit("b", u, plan=plan,
                                     direction="backward") for u in b]
        elif t == "c":
            tickets[t] = [svc.submit("c", u, plan=plan) for u in c]
        else:
            tickets[t] = [svc.submit_reshard("d", u, pout) for u in d]
    return tickets


def _psvc_check(torch, pat, plan, traffic, tickets, pout, diffs, label):
    """Every served result against its sequential call (``plan.compile()``
    at B = 1 for the FFTs, ``reshard`` for ``d``), owning its storage."""
    a, b, c, d = traffic
    cp = plan.compile(())
    refs = {"a": lambda i: cp.forward(pat.PencilArray.from_global(
                plan.input_pencil, a[i])),
            "b": lambda i: cp.backward(pat.PencilArray.from_global(
                plan.output_pencil, b[i])),
            "c": lambda i: cp.forward(c[i]),
            "d": lambda i: pat.reshard(d[i], pout)}
    for t, ts in tickets.items():
        for i, tk in enumerate(ts):
            got = tk.result(600)
            ref = refs[t](i)
            _psvc_owned(got, ref.data.shape)
            _psvc_same(torch, got.data, ref.data, f"{label} {t}[{i}]", diffs,
                       fft=t != "d")
            del got, ref


def _psvc_arm(torch, pat, k1, plan, traffic, pout, max_batch, diffs):
    """One arm: a warm-up pass (every batch size the traffic forms,
    captured), then the timed pass with K1 counted from 0 and the peak
    above the idle service, and the card after ``close()``; its metrics
    and recorded K1 classes."""
    from pencilarrays_tpu_torch.serve import PlanService

    plan.release_compiled()     # the previous arm's references' graphs
    gc.collect()
    base = torch.cuda.memory_allocated()
    svc = PlanService(max_batch=max_batch, max_wait_s=60.0)
    # the warm-up forms the timed pass's batch sizes from device
    # payloads (zeros), so it captures every graph without the host work
    a, b, c, d = traffic
    zf = [plan.allocate_input() for _ in range(min(max_batch, len(a)))]
    zb = [plan.allocate_output() for _ in range(min(max_batch, len(b)))]
    warm = _psvc_submit(svc, plan, ([], [], zf, d[:max_batch]), pout,
                        tenants="cd")
    warm["b"] = [svc.submit("b", u, plan=plan, direction="backward")
                 for u in zb]
    svc.drain()
    for ts in warm.values():
        for tk in ts:
            tk.result(600)
    del warm, zf, zb, ts, tk
    torch.cuda.synchronize()
    n_warm = len(svc.batch_timings())
    idle = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _reset_k1(k1)
    k1.recorded = {}
    t0 = time.perf_counter()
    tickets = _psvc_submit(svc, plan, traffic, pout)
    svc.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"launches": k1.launches,
                "launches_by_instance": dict(k1.launches_by_instance)}
    recorded, k1.recorded = k1.recorded, None
    peak = torch.cuda.max_memory_allocated() - idle
    batches = svc.batch_timings()[n_warm:]
    nreq = sum(len(v) for v in tickets.values())
    per_key = {}
    for bt in batches:
        per_key[bt["key"]] = per_key.get(bt["key"], 0) + 1
    lat = {}
    for t, ts in tickets.items():
        ms = sorted((tk.t_done - tk.t_submit) * 1e3 for tk in ts)
        lat[t] = {"p50_ms": ms[len(ms) // 2],
                  "p99_ms": ms[min(len(ms) - 1,
                                   math.ceil(0.99 * len(ms)) - 1)]}
    r = dict(max_batch=max_batch, requests=nreq, wall_s=wall,
             requests_per_s=nreq / wall, dispatches_per_key=per_key,
             tenants=lat, peak_above_idle_gib=_gib(peak),
             batches=[{k: v for k, v in bt.items() if k != "key"}
                      for bt in batches], **launches)
    graphs = {f"{k[0]}:{k[1]}": v for k, v in
              svc.registry.graph_info().items()}
    svc.close()
    r["after_close"] = _psvc_freed(torch, base, tickets,
                                   f"max_batch={max_batch} close()")
    _psvc_check(torch, pat, plan, traffic, tickets, pout, diffs,
                f"max_batch={max_batch}")
    del tickets
    return r, recorded, graphs


# What the card may hold after a service's close() beyond what it held
# before the service and the results still referenced: small caches
# (cuFFT, K1); one leaked 512^3 sample is 512 MiB, a batch's graph GiBs.
PSVC_LEFT_BYTES = 64 << 20


def _psvc_freed(torch, base, tickets, what):
    """After ``what``, the card holds what it held at ``base`` and the
    served results still referenced (each its own storage), within
    ``PSVC_LEFT_BYTES``: the service's CUDA graphs, their pool and its
    batch buffers are gone."""
    gc.collect()
    held = sum(tk.result(600).data.untyped_storage().nbytes()
               for ts in tickets.values() for tk in ts)
    left = torch.cuda.memory_allocated() - base - held
    torch.cuda.empty_cache()
    r = dict(allocated_left_gib=_gib(left), results_held_gib=_gib(held),
             reserved_gib=_gib(torch.cuda.memory_reserved()))
    if not abs(left) <= PSVC_LEFT_BYTES:
        raise AssertionError(f"[plan_service] after {what} the card holds "
                             f"{_gib(left):.3f} GiB beyond the results: "
                             f"{r}")
    return r


def _psvc_drills(torch, pat, k1, plan, traffic, pout, d, diffs):
    """Isolation, overload and precision drills, journaled, the journal
    linted and one coalesced request reconstructed by
    ``python -m pencilarrays_tpu_torch.obs request``."""
    import numpy as np

    from pencilarrays_tpu_torch import guard, obs
    from pencilarrays_tpu_torch.guard import IntegrityError
    from pencilarrays_tpu_torch.resilience import RetryPolicy, faults
    from pencilarrays_tpu_torch.serve import (SLO, AdmissionError,
                                              PlanService, PressurePolicy,
                                              precision)

    a, b, c, dd = traffic
    jdir = os.path.join(d, "obs")
    # armed by the environment, as phase 5d arms it: a programmatic
    # obs.disable() would keep the journal off for every later phase
    os.environ["PENCILARRAYS_TPU_OBS"] = jdir
    res = {}
    try:
        # isolation: the guard armed (the eager schedule), every exchange
        # corrupted: on one card only the reshard batch makes a hop
        guard.enable(os.path.join(d, "bundles"))
        svc = PlanService(max_batch=8, max_wait_s=60.0,
                          retry=RetryPolicy(max_attempts=1))
        sub = (a[:2], b[:0], c[:2], dd[:2])
        with faults.active("hop.exchange:corrupt"):
            tickets = _psvc_submit(svc, plan, sub, pout, tenants="acd")
            svc.drain()
        guard.disable()
        errs = [tk.error() for tk in tickets["d"]]
        if not all(isinstance(e, IntegrityError) for e in errs):
            raise AssertionError(f"[plan_service] isolation: d's tickets "
                                 f"{[type(e).__name__ for e in errs]}")
        _psvc_check(torch, pat, plan, sub, {t: tickets[t] for t in "ac"},
                    pout, diffs, "isolation")
        trace = next(e["trace"] for e in obs.read_journal(jdir)
                     if e["ev"] == "serve.coalesce" and e["n"] >= 2
                     and e["key"].startswith("fft:"))
        res["isolation"] = dict(stats=svc.stats()["completed"],
                                d=[type(e).__name__ for e in errs])
        svc.close()
        del tickets
        # overload: the protected tier under its deadline, the sheddable
        # one rejected typed at submit
        svc = PlanService(
            max_batch=8, max_wait_s=60.0,
            slos={"prot": SLO(deadline_s=60.0, shed_priority=10),
                  "bulk": SLO(shed_priority=0)},
            pressure=PressurePolicy(high_water_s=1e-4, low_water_s=5e-5))
        w = svc.submit_reshard("prot", dd[0], pout)
        svc.drain()
        w.result(600)
        prot = [svc.submit_reshard("prot", u, pout) for u in dd]
        shed = []
        for u in dd:
            try:
                svc.submit_reshard("bulk", u, pout)
                shed.append("admitted")
            except AdmissionError as e:
                shed.append(e.reason)
        svc.drain()
        if shed != ["shed"] * len(dd):
            raise AssertionError(f"[plan_service] overload: bulk {shed}")
        late = [tk.t_done - tk.t_submit for tk in prot]
        if max(late) >= 60.0 or svc.stats()["slo_violations"]:
            raise AssertionError(f"[plan_service] overload: protected "
                                 f"{late} s")
        _psvc_check(torch, pat, plan, ([], [], [], dd), {"d": prot}, pout,
                    diffs, "overload")
        res["overload"] = dict(shed=shed, protected_s=late,
                               pressure=svc.stats()["pressure"])
        svc.close()
        del prot
        # precision: sheddable budget tenants' reshards on cheaper wires
        env16 = precision.wire_error_envelope("bf16")
        svc = PlanService(
            max_batch=8, max_wait_s=60.0,
            slos={"gold": SLO(shed_priority=2),
                  "flex16": SLO(shed_priority=0, max_rel_l2=env16),
                  "flex8": SLO(shed_priority=0, max_rel_l2=0.5)},
            pressure=PressurePolicy(high_water_s=1.0, low_water_s=0.1,
                                    degrade_water_s=0.5))
        svc._gate._state = "degrade"        # held: the rung, not the load
        svc._gate.update = lambda *args, **kw: "degrade"
        ts = {t: svc.submit_reshard(t, dd[0], pout)
              for t in ("gold", "flex16", "flex8")}
        svc.drain()
        ref = pat.reshard(dd[0], pout).data
        rungs = {e["tenant"]: e for e in obs.read_journal(jdir)
                 if e["ev"] == "serve.precision"}
        prec = {}
        for t, tk in ts.items():
            got = tk.result(600).data
            err = float(torch.linalg.vector_norm((got - ref).double())
                        / torch.linalg.vector_norm(ref.double()))
            rung = rungs.get(t)
            prec[t] = dict(rel_l2=err, wire=rung["wire_to"] if rung else
                           None, envelope=rung["envelope"] if rung else 0.0)
            if not err <= prec[t]["envelope"]:
                raise AssertionError(f"[plan_service] precision {t}: "
                                     f"{prec[t]}")
            del got
        if prec["flex8"]["wire"] is None or prec["flex8"]["rel_l2"] <= 0:
            raise AssertionError(f"[plan_service] precision: {prec}")
        res["precision"] = prec
        svc.close()
        del ts, ref
    finally:
        guard.disable()
        os.environ.pop("PENCILARRAYS_TPU_OBS", None)
    events = obs.read_journal(jdir)
    lint = obs.lint_journal(events)
    if lint:
        raise AssertionError(f"[plan_service] journal: {lint[:5]}")
    cli = subprocess.run(
        [sys.executable, "-m", "pencilarrays_tpu_torch.obs", "request",
         jdir, trace], capture_output=True, text=True, timeout=120)
    if cli.returncode != 0 or trace[:8] not in cli.stdout:
        raise AssertionError(f"[plan_service] pa-obs request rc "
                             f"{cli.returncode}: {cli.stdout[-800:]}"
                             f"{cli.stderr[-800:]}")
    res["journal"] = dict(records=len(events), request=trace,
                          request_lines=len(cli.stdout.splitlines()))
    return res


def _psvc_copies(torch, k1, plan, bw, B=8):
    """K1's split and stack at the coalesced batch's shapes, timed alone
    (CUDA events, 3 calls) against their bound (every byte read once and
    written once)."""
    from pencilarrays_tpu_torch.serve.service import PlanService, _split_fn

    out = plan.allocate_output((B,)).data
    split_ms = cuda_ms(torch, lambda: _split_fn(B)(out), 3)
    nbytes = 2 * out.numel() * out.element_size()
    xs = [plan.allocate_input() for _ in range(B)]
    stack_ms = cuda_ms(torch, lambda: PlanService._stack(xs), 3)
    sbytes = 2 * B * xs[0].data.numel() * xs[0].data.element_size()
    r = dict(split_ms=split_ms, split_bound_ms=nbytes / bw * 1e3,
             split_gib=_gib(nbytes / 2), stack_ms=stack_ms,
             stack_bound_ms=sbytes / bw * 1e3, stack_gib=_gib(sbytes / 2))
    del out, xs
    torch.cuda.empty_cache()
    return r


def _psvc_shared(torch, pat, plan, traffic, pout, diffs, most=200):
    """The plan's graph pool shared across threads and streams: a user's
    own ``plan.compile(())`` replayed on a thread and a stream of its own
    while a service on the same plan serves tenants ``a`` and ``c`` in
    batches of up to 8 (graphs of the same pool).  Every user result is
    the eager chain's bits, every served one the sequential call's; the
    user calls made while the service drained are counted."""
    import threading

    from pencilarrays_tpu_torch.serve import PlanService

    a, b, c, d = traffic
    x = c[0]
    ref = plan.forward(x).data
    cp = plan.compile(())
    cp.forward(x)                       # captured before the race
    svc = PlanService(max_batch=8, max_wait_s=60.0)
    draining = threading.Event()
    res = dict(calls=0, overlapped=0, bad=[], error=None)

    def user():
        side = torch.cuda.Stream()
        try:
            with torch.cuda.stream(side):
                while res["calls"] < most and (
                        draining.is_set() or res["calls"] < 4):
                    y = cp.forward(x).data
                    res["overlapped"] += draining.is_set()
                    if not same_bits(torch, y, ref):
                        res["bad"].append(max_abs_err(torch, y, ref))
                    res["calls"] += 1
                    del y
            side.synchronize()
        except BaseException as e:      # noqa: BLE001 - reported below
            res["error"] = repr(e)

    sub = (a, [], c, [])
    tickets = _psvc_submit(svc, plan, sub, pout, tenants="ac")
    th = threading.Thread(target=user)
    draining.set()
    th.start()
    try:
        svc.drain()
    finally:
        draining.clear()
        th.join(600)
    _psvc_check(torch, pat, plan, sub, tickets, pout, diffs, "shared pool")
    res["served"] = svc.stats()["completed"]
    svc.close()
    del tickets
    if res["error"] or res["bad"] or not res["overlapped"]:
        raise AssertionError(f"[plan_service] shared pool: {res}")
    return res


def phase_plan_service(torch, pat, k1, bw, n=512, n_fft=8, n_resh=4):
    """Phase 5g: the plan service (``serve/``) at BASELINE config 3, the
    512^3 r2c f32 PencilFFT, on a (1, 1) topology: tenants ``a`` (host
    forwards), ``b`` (host backwards), ``c`` (device forwards), ``d``
    (reshards of 512^3 f32 between two pencils), coalesced
    (``max_batch=8``) and serialized (``max_batch=1``), each arm's
    service closed and the card back to what it held before it but the
    results; then the isolation, overload, precision and shared-pool
    drills, and the card back to the phase's start once the plan's own
    executables are released."""
    import numpy as np

    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    start = torch.cuda.memory_allocated()
    root = os.path.dirname(os.path.abspath(__file__))
    d = os.path.join(root, PSVC_DIR)
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    topo = pat.Topology((1, 1))
    plan = pat.PencilFFTPlan(topo, (n, n, n), real=True,
                             dtype=torch.float32)
    pin = pat.Pencil(topo, (n, n, n), (1, 2))
    pout = pin.replace(decomp_dims=(0, 2))
    t = time.perf_counter()
    traffic = _psvc_traffic(np, pat, plan, pin, n_fft, n_resh, SEED + 14)
    make_s = time.perf_counter() - t
    diffs = []
    try:
        arms, recorded, graphs = {}, {}, {}
        for name, mb in (("coalesced", 8), ("serialized", 1)):
            arms[name], rec, g = _psvc_arm(torch, pat, k1, plan, traffic,
                                           pout, mb, diffs)
            graphs.update(g)
            for cls, c in rec.items():
                recorded[cls] = recorded.get(cls, 0) + c
            log(f"[plan_service] {name} (max_batch={mb}) at {n}^3: "
                + json.dumps(arms[name]))
        co = arms["coalesced"]["dispatches_per_key"]
        want = {"fft-forward": 2, "fft-backward": 1, "reshard": 1}
        got = {"fft-forward": sum(v for k, v in co.items()
                                  if k.endswith(":forward")),
               "fft-backward": sum(v for k, v in co.items()
                                   if k.endswith(":backward")),
               "reshard": sum(v for k, v in co.items()
                              if k.startswith("reshard:"))}
        if got != want:
            raise AssertionError(f"[plan_service] coalesced dispatches "
                                 f"{got}, want {want}")
        drills = _psvc_drills(torch, pat, k1, plan, traffic, pout, d, diffs)
        drills["shared_pool"] = _psvc_shared(torch, pat, plan, traffic,
                                             pout, diffs)
        log("[plan_service] drills: " + json.dumps(drills))
        copies = _psvc_copies(torch, k1, plan, bw)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    if plan.topology.device.type == "cuda" and not any(
            v.get("pool_total_bytes", 0) > 0 for g in graphs.values()
            for v in g.values()):
        raise AssertionError(f"[plan_service] no graph pool measured: "
                             f"{graphs}")
    # the plan's own executables (the sequential references' B = 1 and
    # the shared-pool drill's) go with the phase, by the plan's public
    # release: the engine's dispatch log keeps the plan object alive
    del traffic
    released = plan.release_compiled()
    freed = _psvc_freed(torch, start, {}, "release_compiled()")
    freed["graphs_released"] = released
    r = dict(freed=freed,arms=arms, graphs=graphs, drills=drills, copies=copies,
             diffs=diffs, make_payloads_s=make_s,
             speedup=arms["coalesced"]["requests_per_s"]
             / arms["serialized"]["requests_per_s"],
             seconds=time.perf_counter() - t0)
    log(f"[plan_service] pools {json.dumps(graphs)}; after the release "
        f"{json.dumps(freed)}; K1 split and stack "
        f"{json.dumps(copies)}; results off the sequential bits "
        f"{json.dumps(diffs)}; coalesced / serialized requests/s "
        f"{r['speedup']:.3f}; phase 5g took {r['seconds']:.1f} s")
    co = arms["coalesced"]
    r["paths"] = {"plan_service": {
        "launches": co["launches"] + arms["serialized"]["launches"],
        "launches_by_instance": {
            i: co["launches_by_instance"][i]
            + arms["serialized"]["launches_by_instance"][i]
            for i in k1.INSTANCES}}}
    r["recorded"] = recorded
    if r["paths"]["plan_service"]["launches"] <= 0:
        raise AssertionError("the plan service launched K1 no time")
    return r


FLEET_DIR = "chip_smoke_fleet"
# The leases' ttl, the drills' and the storm's.  A worker's heartbeat is
# a thread of its process, and the wire's codec holds the interpreter
# lock for as long as it encodes or decodes a capsule: about 1 s for a
# 256^3 one (85 MiB of base64), seconds at 512^3 (683 MiB).  A lease
# shorter than that expires on a live mesh, and the router finds none:
# the JAX package's 2 s did so in the storm and in a drill.
FLEET_TTL = 5.0
FLEET_STORM_TTL = 30.0
FLEET_FREE_BYTES = 10 << 30     # the card two storm workers must leave free


def _fleet_spawn(root, d, mesh, whale_n, minnow_n, *, fault="",
                 max_s=900, warm="minnow,whale", ttl=FLEET_TTL,
                 device="cuda"):
    """One mesh process of ``tests/torch_fleet_worker.py`` (on
    ``device``: the card, or the CPU in a rehearsal), joined by the
    ``FileKV`` under ``d``, advertising the plans ``warm`` as warm; its
    output in ``d/m<mesh>.log``."""
    worker = os.path.join(root, "tests", "torch_fleet_worker.py")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PENCILARRAYS_TPU_")}
    env.update(PA_FLEET_TEST_TTL=str(ttl),
               PENCILARRAYS_TPU_FAULTS=fault,
               PENCILARRAYS_TPU_OBS=os.path.join(d, "obs"))
    env.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    args = [sys.executable, worker, os.path.join(d, "kv"), str(mesh), d,
            str(max_s), device, str(whale_n), str(minnow_n), warm]
    with open(os.path.join(d, f"m{mesh}.log"), "w") as out:
        return subprocess.Popen(args, env=env, stdout=out,
                                stderr=subprocess.STDOUT, text=True)


def _fleet_log(d, mesh):
    with open(os.path.join(d, f"m{mesh}.log")) as f:
        return f.read()


def _fleet_await(fleet, kv, procs, d, timeout=180.0, ttl=FLEET_TTL):
    """Every mesh's lease live; a worker that exits first (no card, a
    failed start) fails the phase with its output."""
    board = fleet.MeshBoard(kv, ttl=ttl)
    meshes = sorted(procs)
    t_end = time.monotonic() + timeout
    while time.monotonic() < t_end:
        if board.live_meshes(meshes) == meshes:
            return
        for m, p in procs.items():
            if p.poll() is not None:
                raise AssertionError(f"[fleet] mesh {m} exited rc "
                                     f"{p.returncode} before serving:\n"
                                     f"{_fleet_log(d, m)[-3000:]}")
        time.sleep(0.1)
    raise AssertionError(f"[fleet] meshes {meshes} never all came alive")


def _fleet_stop(kv, procs, d, timeout=240.0, failed=False):
    """Retire every live mesh by its stop key and wait for it (after a
    failure, kill it and print the end of its output); each one's
    output."""
    for m, p in procs.items():
        if p.poll() is None:
            if failed:
                p.kill()
            else:
                kv.set(f"pa/fleet/stop/m{m}", "stop")
    t_end = time.monotonic() + timeout
    for p in procs.values():
        try:
            p.wait(timeout=max(1.0, t_end - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
    outs = {m: _fleet_log(d, m) for m in procs}
    if failed:
        for m, out in outs.items():
            log(f"[fleet] mesh {m}'s output (end):\n{out[-4000:]}")
    return outs


def _fleet_json(out, tag):
    m = re.search(rf"^{tag} (\{{.*\}})$", out, re.M)
    return json.loads(m.group(1)) if m else None


def _fleet_exited(outs, what):
    """Every retired worker left cleanly, its resident variants
    certified; their ``CERTIFY`` and ``STATS`` lines by mesh."""
    rep = {}
    for m, out in outs.items():
        cert = _fleet_json(out, "CERTIFY")
        if f"EXITED mesh={m}" not in out or cert is None \
                or not cert["ok"]:
            raise AssertionError(f"[fleet] {what}: mesh {m} did not exit "
                                 f"certified:\n{out[-3000:]}")
        rep[m] = {"certify": cert, "stats": _fleet_json(out, "STATS")}
    return rep


def _fleet_refs(torch, pat, n, requests, device="cuda"):
    """Each request's sequential call (``compile(())``, B = 1) on a
    ``(1, 1)`` topology in this process, gathered to the host: the
    reference a served result is held to (yielded one at a time)."""
    topo = pat.Topology((1, 1), device=device)
    plan = pat.PencilFFTPlan(topo, (n, n, n), real=True,
                             dtype=torch.float32)
    cp = plan.compile(())
    try:
        for direction, u in requests:
            fwd = direction == "forward"
            x = pat.PencilArray.from_global(
                plan.input_pencil if fwd else plan.output_pencil, u)
            yield pat.gather((cp.forward if fwd else cp.backward)(x))
            del x
    finally:
        plan.release_compiled()


def _fleet_check(np, got, ref, what, diffs):
    """A served result against its sequential call: the bits, or within
    ``PSVC_FFT_TOL`` of max|ref| (cuFFT's batched rounding, as phase 5g
    holds FFTs); the wire's own round trip is bit-exact."""
    if got.shape != ref.shape or got.dtype != ref.dtype:
        raise AssertionError(f"[fleet] {what}: {got.shape} {got.dtype}, "
                             f"want {ref.shape} {ref.dtype}")
    if np.array_equal(got, ref):
        return
    err = float(np.abs(got - ref).max()
                / max(float(np.abs(ref).max()), 1e-30))
    diffs.append({"what": what, "rel_err": err})
    if not err <= PSVC_FFT_TOL:
        raise AssertionError(f"[fleet] {what}: max|diff| / max|ref| "
                             f"{err:.3e} above {PSVC_FFT_TOL}")


def _fleet_payloads(np, rng, n, small, plan):
    """``(tenant, name, direction, payload)`` per request of ``plan``,
    a list of ``(tenant, count)``: ``a`` whale forwards (real n^3),
    ``b`` whale backwards (complex spectra), ``c`` minnow forwards
    (real small^3)."""
    out = []
    for tenant, count in plan:
        for _ in range(count):
            if tenant == "a":
                out.append(("a", "whale", "forward",
                            rng.random((n,) * 3, dtype=np.float32) - 0.5))
            elif tenant == "b":
                x = np.empty((n // 2 + 1, n, n), np.complex64)
                rng.random(out=x.view(np.float32), dtype=np.float32)
                out.append(("b", "whale", "backward", x))
            else:
                out.append(("c", "minnow", "forward",
                            rng.random((small,) * 3, dtype=np.float32)
                            - 0.5))
    return out


def _pct(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, max(0, math.ceil(q * len(xs)) - 1))]


def _fleet_storm(torch, np, pat, root, d, n, small, acc, device, n_whale,
                 n_minnow):
    """The timed storm: two mesh processes sharing the card (whale n^3,
    minnow small^3), the router in this process (no WAL, no device);
    tenants a, b, c submitted in that order and pumped until every
    ticket resolved; the card's free memory read throughout; then the
    workers retire, certify and report, and every result is held to its
    sequential call.  Mesh 1 advertises the minnow warm and mesh 2 the
    whale: a worker exports its load between takes, when its queue is
    empty, so the backlog term ties and the compile-cache locality term
    places (with both warm, every request would tie to mesh 1)."""
    from pencilarrays_tpu_torch import fleet, obs
    from pencilarrays_tpu_torch.cluster.kv import FileKV
    from pencilarrays_tpu_torch.fleet import wire

    sd = os.path.join(d, "storm")
    os.makedirs(sd)
    kv = FileKV(os.path.join(sd, "kv"))
    t = time.perf_counter()
    reqs = _fleet_payloads(np, np.random.default_rng(SEED + 15), n, small,
                           [("a", n_whale), ("b", n_whale),
                            ("c", n_minnow)])
    make_s = time.perf_counter() - t
    # the router's wire parts by ticket: a harness probe around the
    # codec and the KV writes (neither is changed)
    parts = {}
    plain_enc, plain_dec, plain_set = (wire.encode_request,
                                       wire.decode_result, kv.set)

    def enc(tid, **kw):
        t = time.perf_counter()
        out = plain_enc(tid, **kw)
        parts.setdefault(tid, {})["router_encode_s"] = \
            time.perf_counter() - t
        return out

    def dec(raw):
        t = time.perf_counter()
        out = plain_dec(raw)
        parts.setdefault(out[0]["ticket"], {}).update(
            router_decode_s=time.perf_counter() - t,
            service_s=out[0]["seconds"], mesh=out[0]["mesh"])
        return out

    def kv_set(key, value):
        t = time.perf_counter()
        plain_set(key, value)
        if "/req/" in key:
            parts.setdefault(wire.ticket_id_of(key), {})[
                "router_kv_write_s"] = time.perf_counter() - t

    def free():
        return torch.cuda.mem_get_info()[0] if device == "cuda" else None

    procs = {m: _fleet_spawn(root, sd, m, n, small, device=device,
                             warm={1: "minnow", 2: "whale"}[m],
                             ttl=FLEET_STORM_TTL)
             for m in (1, 2)}
    router = None
    frees = []
    ok = False
    try:
        _fleet_await(fleet, kv, procs, sd, ttl=FLEET_STORM_TTL)
        # armed by the environment, as phase 5g arms it: a programmatic
        # disable would keep the journal off for every later phase
        os.environ["PENCILARRAYS_TPU_OBS"] = os.path.join(sd, "obs")
        wire.encode_request, wire.decode_result = enc, dec
        kv.set = kv_set
        router = fleet.FleetRouter(kv, ttl=FLEET_STORM_TTL)
        router.register_mesh(1)
        router.register_mesh(2)
        t0 = time.perf_counter()
        tickets = []
        for tenant, name, direction, u in reqs:
            tickets.append(router.submit(tenant, u, name=name,
                                         direction=direction))
            router.pump()
            frees.append(free())
        log(f"[fleet] storm: {len(reqs)} requests submitted in "
            f"{time.perf_counter() - t0:.1f} s")
        t_end = time.monotonic() + 600.0
        while router.stats()["pending"] and time.monotonic() < t_end:
            router.pump()
            frees.append(free())
            time.sleep(0.005)
        wall = time.perf_counter() - t0
        stats = router.stats()
        if stats["pending"] or stats["completed"] != len(reqs) or \
                stats["failed"] or stats["duplicates"]:
            raise AssertionError(f"[fleet] storm: {stats}")
        ok = True
    finally:
        wire.encode_request, wire.decode_result = plain_enc, plain_dec
        if router is not None:
            router.close()
        os.environ.pop("PENCILARRAYS_TPU_OBS", None)
        outs = _fleet_stop(kv, procs, sd, failed=not ok)
    workers = _fleet_exited(outs, "storm")
    _cluster_k1(outs.values(), acc)
    for out in outs.values():
        for line in re.findall(r"^WIRE (\{.*\})$", out, re.M):
            w = json.loads(line)
            parts.setdefault(w["tid"], {}).update(
                worker_decode_s=w["decode_s"], worker_encode_s=w["encode_s"],
                worker_kv_write_s=w["kv_write_s"], result_bytes=w["bytes"])
    events = obs.read_journal(os.path.join(sd, "obs"))
    placed = {}
    for e in events:
        if e["ev"] == "fleet.route" and e["reason"] == "placed":
            placed[e["mesh"]] = placed.get(e["mesh"], 0) + 1
    lat = {}
    for (tenant, *_), tk in zip(reqs, tickets):
        lat.setdefault(tenant, []).append(tk.t_done - tk.t_submit)
    whales = [dict(tenant=tenant, direction=direction,
                   **parts.get(str(tk.id), {}))
              for (tenant, name, direction, _), tk in zip(reqs, tickets)
              if name == "whale"]
    frees = [f for f in frees if f is not None]
    res = dict(
        requests=len(reqs), whale_n=n, minnow_n=small, wall_s=wall,
        requests_per_s=len(reqs) / wall, make_payloads_s=make_s,
        latency_s={t: {"p50": _pct(v, 0.5), "p99": _pct(v, 0.99)}
                   for t, v in sorted(lat.items())},
        placed_per_mesh={str(m): c for m, c in sorted(placed.items())},
        whale_wire_s=whales, workers=workers,
        min_free_gib=_gib(min(frees)) if frees else None)
    if frees and min(frees) < FLEET_FREE_BYTES:
        raise AssertionError(f"[fleet] the two workers left "
                             f"{_gib(min(frees)):.2f} GiB of the card free, "
                             f"under {_gib(FLEET_FREE_BYTES):.0f}")
    # every result against its sequential call on the card
    diffs = []
    t = time.perf_counter()
    for name, size in (("whale", n), ("minnow", small)):
        mine = [(r, tk) for r, tk in zip(reqs, tickets) if r[1] == name]
        refs = _fleet_refs(torch, pat, size,
                           [(r[2], r[3]) for r, _ in mine], device)
        for ((tenant, _, direction, _), tk), ref in zip(mine, refs):
            _fleet_check(np, np.asarray(tk.result(0)), ref,
                         f"storm {tenant} {name} {direction} #{tk.id}",
                         diffs)
        refs.close()
    res["check_s"] = time.perf_counter() - t
    res["diffs"] = diffs
    return res


def _fleet_drills(torch, np, pat, root, d, n, small, acc, device):
    """The drills at whale n^3 and minnow small^3: (a) whole-mesh loss
    (``fleet.route:kill%mesh1@4`` in both workers' environments), (b) a
    router process SIGKILLed at its 7th admission and its WAL replayed
    by a fresh router, (c) the surviving mesh retired by its stop key;
    every ticket resolved exactly once and held to its sequential call,
    and the merged journal linted, rendered and one rebound request
    reconstructed by ``python -m pencilarrays_tpu_torch.obs``."""
    import signal

    from pencilarrays_tpu_torch import fleet, obs
    from pencilarrays_tpu_torch.cluster.kv import FileKV
    from pencilarrays_tpu_torch.obs.requestflow import reconstruct_request

    dd = os.path.join(d, "drills")
    os.makedirs(dd)
    obsdir = os.path.join(dd, "obs")
    kv = FileKV(os.path.join(dd, "kv"))
    rng = np.random.default_rng(SEED + 16)
    res = {}
    procs = {m: _fleet_spawn(root, dd, m, n, small, device=device,
                             fault="fleet.route:kill%mesh1@4")
             for m in (1, 2)}
    router = None
    ok = False
    try:
        _fleet_await(fleet, kv, procs, dd)
        os.environ["PENCILARRAYS_TPU_OBS"] = obsdir
        # (a) whole-mesh loss: a mixed burst lands on mesh 1 (both warm,
        # no backlog exported: the tie breaks low), whose 4th take dies
        router = fleet.FleetRouter(kv, ttl=FLEET_TTL)
        router.register_mesh(1)
        router.register_mesh(2)
        wave = [_fleet_payloads(np, rng, n, small,
                                [("a" if i % 3 == 0 else "c", 1)])[0]
                for i in range(12)]
        t0 = time.monotonic()
        tickets = [router.submit(tenant, u, name=name, direction=direction)
                   for tenant, name, direction, u in wave]
        t_kill = t_rebind = None
        pumps = []      # (start, seconds) of each pump up to detection
        t_end = time.monotonic() + 120.0
        while time.monotonic() < t_end:
            if t_kill is None and procs[1].poll() is not None:
                t_kill = time.monotonic()
            p0 = time.monotonic()
            s = router.pump()
            pumps.append((p0, time.monotonic() - p0))
            if s["dead"]:
                if s["rebound"]:
                    t_rebind = p0 + pumps[-1][1]
                break
            time.sleep(0.01)
        if router.stats()["dead_meshes"] != [1] or \
                procs[1].wait(timeout=30) != -signal.SIGKILL:
            raise AssertionError(f"[fleet] drill a: {router.stats()}, "
                                 f"mesh 1 rc {procs[1].returncode}")
        # the sweep that found mesh 1 dead journaled the failover: its
        # clock is this process's, and the pump that ran it went on to
        # re-bind the parked tickets (their payloads encoded anew)
        fo1 = next(e for e in obs.read_journal(obsdir)
                   if e["ev"] == "fleet.failover" and e["mesh"] == 1)
        t_detect = fo1["t_mono"]
        t_kill = min(t_kill or t_detect, t_detect)
        while t_rebind is None and time.monotonic() < t_end:
            if router.pump()["rebound"]:
                t_rebind = time.monotonic()
        while not all(tk.done() for tk in tickets) and \
                time.monotonic() < t_end:
            router.pump()
            time.sleep(0.005)
        t_resolved = time.monotonic()
        # The lease expires at most TTL after the kill (its last beat came
        # before it), and the router sweeps once a pump, after harvesting
        # results: detection comes at most one pump (the one running at
        # expiry, with the loop's 10 ms sleep) plus the detecting pump's
        # harvest after expiry.  0.25 s covers the failover record's fsync
        # and the poll that stamps the kill.
        before = max((d for _, d in pumps[:-1]), default=0.0)
        harvest = t_detect - pumps[-1][0]
        bound = FLEET_TTL + before + 0.01 + harvest + 0.25
        if t_detect - t_kill > bound:
            raise AssertionError(
                f"[fleet] drill a: mesh loss detected {t_detect - t_kill:.3f}"
                f" s after the kill, over TTL {FLEET_TTL} + one pump "
                f"{before:.3f} + harvest {harvest:.3f} + 0.26 s")
        wave2 = _fleet_payloads(np, rng, n, small, [("a", 1), ("c", 3)])
        tickets += [router.submit(tenant, u, name=name, direction=direction)
                    for tenant, name, direction, u in wave2]
        wave += wave2
        if router.drain(120.0):
            raise AssertionError(f"[fleet] drill a: {router.stats()}")
        st = router.stats()
        if st["completed"] != len(wave) or st["failed"] or \
                st["duplicates"]:
            raise AssertionError(f"[fleet] drill a: {st}")
        res["mesh_loss"] = dict(
            requests=len(wave), stats=st, ttl_s=FLEET_TTL,
            detect_s=t_detect - t_kill, detect_bound_s=bound,
            lease_age_at_detect_s=fo1["detect_s"], pumps=len(pumps),
            longest_pump_before_s=before, detect_pump_harvest_s=harvest,
            detect_pump_s=pumps[-1][1], rebind_round_s=t_rebind - t_detect,
            resolve_s=t_resolved - t_rebind,
            time_to_recover_s=t_resolved - t_kill,
            wave1_s=t_resolved - t0)
        router.close()
        router = None
        os.environ.pop("PENCILARRAYS_TPU_OBS", None)
        # (b) the router SIGKILLed at its 7th admission, its WAL replayed
        waldir = os.path.join(dd, "wal")
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("PENCILARRAYS_TPU_")}
        env.update(PA_FLEET_TEST_TTL=str(FLEET_TTL),
                   PENCILARRAYS_TPU_FAULTS="fleet.route:kill@7",
                   PENCILARRAYS_TPU_OBS=obsdir,
                   PENCILARRAYS_TPU_CLUSTER_RANK="3")
        rproc = subprocess.run(
            [sys.executable, os.path.join(root, "tests",
                                          "torch_router_worker.py"),
             os.path.join(dd, "kv"), waldir, "10", "2", "minnow",
             str(small)], env=env, capture_output=True, text=True,
            timeout=240)
        if rproc.returncode != -signal.SIGKILL or \
                "ROUTER_READY" not in rproc.stdout:
            raise AssertionError(f"[fleet] drill b: router rc "
                                 f"{rproc.returncode}\n"
                                 f"{(rproc.stdout + rproc.stderr)[-3000:]}")
        os.environ["PENCILARRAYS_TPU_OBS"] = obsdir
        t = time.perf_counter()
        router = fleet.FleetRouter(kv, ttl=FLEET_TTL, wal_dir=waldir)
        router.register_mesh(2)
        rep = router.recover()
        with router._lock:
            held = [(p.ticket, np.asarray(p.payload))
                    for p in router._pending.values()]
        if rep["outcome"] != "clean" or \
                rep["resolved"] + rep["reparked"] != 6 or \
                len(held) != rep["reparked"] or router.drain(120.0):
            raise AssertionError(f"[fleet] drill b: {rep}, "
                                 f"{router.stats()}")
        recover_s = time.perf_counter() - t
        st = router.stats()
        rep2 = router.recover()
        records, skipped = fleet.wal.read_wal(waldir)
        fold = fleet.wal.replay(records)
        if st["completed"] != rep["reparked"] or st["failed"] or \
                st["duplicates"] or rep2["reparked"] or \
                rep2["resolved"] != 6 or skipped or fold["pending"] or \
                fold["duplicates"] or len(fold["resolved"]) != 6:
            raise AssertionError(f"[fleet] drill b: {st}, {rep2}, "
                                 f"{skipped}, {fold}")
        wal_bytes = sum(os.path.getsize(os.path.join(waldir, f))
                        for f in os.listdir(waldir))
        res["router_wal"] = dict(
            recover=rep, stats=st, recover_and_drain_s=recover_s,
            wal_bytes=wal_bytes, wal_bytes_per_admission=wal_bytes / 6,
            records=len(records))
        # (c) the survivor retired by its stop key: a clean leave
        fleet.FleetSupervisor(spawn=lambda m: None, kv=kv).retire(2)
        t = time.perf_counter()
        t_end = time.monotonic() + 4 * FLEET_TTL + 30.0
        while router.stats()["dead_meshes"] != [2] and \
                time.monotonic() < t_end:
            router.pump()
            time.sleep(0.05)
        dead = router._meshes[2]["dead"]
        if not isinstance(dead, fleet.MeshLeftError):
            raise AssertionError(f"[fleet] drill c: mesh 2 {dead!r}")
        res["retire"] = dict(error=type(dead).__name__,
                             seen_s=time.perf_counter() - t)
        ok = True
    finally:
        if router is not None:
            router.close()
        os.environ.pop("PENCILARRAYS_TPU_OBS", None)
        outs = _fleet_stop(kv, procs, dd, failed=not ok)
    _cluster_k1(outs.values(), acc)
    res["workers"] = _fleet_exited({2: outs[2]}, "drills")
    # the resolved tickets of (a) and (b) against their sequential calls
    diffs = []
    served = [(r, tk.result(0)) for r, tk in zip(wave, tickets)]
    served += [(("b", "minnow", "forward", u), tk.result(0))
               for tk, u in held]
    for name, size in (("whale", n), ("minnow", small)):
        mine = [(r, got) for r, got in served if r[1] == name]
        refs = _fleet_refs(torch, pat, size,
                           [(r[2], r[3]) for r, _ in mine], device)
        for (r, got), ref in zip(mine, refs):
            _fleet_check(np, np.asarray(got), ref,
                         f"drill {r[0]} {name}", diffs)
        refs.close()
    res["diffs"] = diffs
    # the merged journal of the router, both meshes and the dead router
    events = obs.read_journal(obsdir)
    fo = [e for e in events if e["ev"] == "fleet.failover"]
    if not any(e["mesh"] == 1 and e["error"] == "MeshFailureError"
               for e in fo) or \
            not any(e["mesh"] == 2 and e["error"] == "MeshLeftError"
                    for e in fo):
        raise AssertionError(f"[fleet] failover records {fo}")
    rebinds = sorted({e["trace"] for e in events
                      if e["ev"] == "fleet.route" and e["reason"] == "rebind"})
    rt, _ = reconstruct_request(obsdir, rebinds[0])
    if rt is None or rt.rebinds < 1 or rt.outcome != "ok" or \
            len(rt.ranks) < 2:
        raise AssertionError(f"[fleet] rebound request {rebinds[0]}: {rt}")
    for args in (["lint", obsdir], ["timeline", obsdir],
                 ["request", obsdir, rebinds[0]]):
        p = subprocess.run([sys.executable, "-m",
                            "pencilarrays_tpu_torch.obs", *args],
                           capture_output=True, text=True, timeout=120,
                           cwd=root)
        if p.returncode != 0:
            raise AssertionError(f"[fleet] pa-obs {args[0]}: rc "
                                 f"{p.returncode}\n{p.stdout[-2000:]}"
                                 f"{p.stderr[-2000:]}")
    res["journal"] = dict(records=len(events), failovers=len(fo),
                          rebound_request=dict(
                              trace=rebinds[0], ranks=sorted(rt.ranks),
                              rebinds=rt.rebinds, outcome=rt.outcome))
    return res


def phase_fleet(torch, k1, n=512, small=128, n_whale=1, n_minnow=16,
                drill_n=256, device="cuda"):
    """Phase 5h: ``fleet/`` and the rest of ``analysis/`` on the card: a
    router in this process (no device) in front of two mesh processes of
    ``tests/torch_fleet_worker.py`` sharing the card, each serving the
    n^3 r2c f32 ``whale`` (BASELINE config 3, phase 5g's plan) and the
    small^3 ``minnow`` through a ``PlanService`` (``max_batch=4``): the
    timed storm, the drills at drill_n^3, each worker's ``certify`` of
    its resident variants, and the port's ``pa-lint`` over the repo.
    The workers load K1 from ``ops/_build`` (built in phase 1); their
    launches (the service's split and stack) count under the path
    ``fleet``."""
    import numpy as np

    import pencilarrays_tpu_torch as pat

    t0 = time.perf_counter()
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
        free, total = torch.cuda.mem_get_info()
        log(f"[fleet] free on the card at the phase's start "
            f"{_gib(free):.2f} of {_gib(total):.2f} GiB")
    root = os.path.dirname(os.path.abspath(__file__))
    d = os.path.join(root, FLEET_DIR)
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    acc = {"launches": 0, "launches_by_instance": {}, "recorded": {}}
    res = {}
    try:
        res["storm"] = _fleet_storm(torch, np, pat, root, d, n, small, acc,
                                    device, n_whale, n_minnow)
        st = res["storm"]
        log(f"[fleet] storm at {n}^3 / {small}^3: {st['requests']} "
            f"requests, {st['requests_per_s']:.3f} requests/s; latency "
            f"{json.dumps(st['latency_s'])}; placed "
            f"{json.dumps(st['placed_per_mesh'])}; min free "
            f"{st['min_free_gib']} GiB; whale wire parts "
            f"{json.dumps(st['whale_wire_s'])}; workers "
            f"{json.dumps(st['workers'])}; off the sequential bits "
            f"{json.dumps(st['diffs'])}")
        res["drills"] = _fleet_drills(torch, np, pat, root, d, drill_n,
                                      small, acc, device)
        log("[fleet] drills: " + json.dumps(res["drills"]))
        t = time.perf_counter()
        p = subprocess.run([sys.executable, "-m",
                            "pencilarrays_tpu_torch.analysis", root,
                            "--no-spmd"], capture_output=True, text=True,
                           timeout=300, cwd=root)
        if p.returncode != 0 or "pa-lint: clean" not in p.stdout:
            raise AssertionError(f"[fleet] pa-lint rc {p.returncode}:\n"
                                 f"{p.stdout[-3000:]}{p.stderr[-2000:]}")
        res["pa_lint"] = dict(rc=p.returncode, seconds=time.perf_counter() - t,
                              summary=p.stdout.strip().splitlines()[-1])
        log(f"[fleet] pa-lint of the port: {res['pa_lint']['summary']}")
    finally:
        shutil.rmtree(d, ignore_errors=True)
    res["recorded"] = acc.pop("recorded")
    res["paths"] = {"fleet": acc}
    res["seconds"] = time.perf_counter() - t0
    log(f"[fleet] phase 5h took {res['seconds']:.1f} s; K1 launches in the "
        f"mesh processes {acc['launches']} {acc['launches_by_instance']}")
    if acc["launches"] <= 0:
        raise AssertionError("the fleet path launched K1 no time")
    return res


# -- phase 5i: gradients on the card -----------------------------------------

NS_EAGER_LIMIT = 70 * 2 ** 30   # run the eager 512^3 NS gradient only below


def _path():
    """A path's K1 counts, each window of its run added (``_k1_window``)."""
    return {"launches": 0, "launches_by_instance": {}, "recorded": {}}


def _k1_window(torch, k1, acc, fn):
    """``fn()`` with K1 counted from 0, the counts added to the path
    ``acc``: ``fn``'s result, its K1 launches, the classes launched and
    its host ms (ending in a synchronize)."""
    torch.cuda.synchronize()
    _reset_k1(k1)
    k1.recorded = {}
    t0 = time.perf_counter()
    try:
        res = fn()
        torch.cuda.synchronize()
    finally:
        rec, k1.recorded = k1.recorded, None
    ms = (time.perf_counter() - t0) * 1e3
    acc["launches"] += k1.launches
    for i, c in k1.launches_by_instance.items():
        acc["launches_by_instance"][i] = acc["launches_by_instance"].get(
            i, 0) + c
    for cls, c in rec.items():
        acc["recorded"][cls] = acc["recorded"].get(cls, 0) + c
    return res, k1.launches, rec, ms


def _peak_from(torch):
    """Reset the peak and return the bytes held now (the base it is read
    above)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def _sq_norm(torch, t):
    """sum |t|^2 (a complex tensor through its real view)."""
    return (torch.view_as_real(t) if t.is_complex() else t).square().sum()


def _warm(torch, fwd):
    """One uncounted forward and backward of ``fwd`` (cuFFT plans,
    autograd's and the checkpoint's first-call set-up), so the counted
    run's ms are a warm call's."""
    fwd().backward()
    torch.cuda.synchronize()


def _grad_reshard(torch, pat, k1, topo, acc, n, bwd_classes):
    """The gradient of sum(v * v), v the 1024^3 f32 reshard between
    pencils differing in both slots and in memory order, by the default
    method (the Gspmd exchange: one K1 permute each way) and by a forced
    ``AllToAll()`` route (its hops over size-1 axes folded into one K1
    permute, differentiated through K1's autograd function): 2u bit for
    bit, K1 launches forward and backward, ms and peak."""
    shape = (n, n, n)
    px = pat.Pencil(topo, shape, (1, 2), permutation=pat.Permutation(1, 2, 0))
    pz = pat.Pencil(topo, shape, (0, 1))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 40)
    u = torch.randn(px.padded_size_local(pat.MemoryOrder), generator=gen,
                    device="cuda")
    rows = {}
    for run, kw in (("default", {}), ("AllToAll", {"method": pat.AllToAll()})):
        leaf = u.clone().requires_grad_()

        def fwd():
            v = pat.reshard(pat.PencilArray(px, leaf), pz, **kw)
            return pat.ops.sum(v * v)

        _warm(torch, fwd)
        leaf.grad = None
        base = _peak_from(torch)
        loss, nf, _, ms_f = _k1_window(torch, k1, acc, fwd)
        _, nb, rec, ms_b = _k1_window(torch, k1, acc, loss.backward)
        peak = torch.cuda.max_memory_allocated() - base
        del loss
        if not same_bits(torch, leaf.grad, 2 * u):
            raise AssertionError(f"reshard gradient ({run}) is not 2u")
        for cls, c in rec.items():
            bwd_classes[cls] = bwd_classes.get(cls, 0) + c
        rows[run] = dict(fwd_launches=nf, bwd_launches=nb, fwd_ms=ms_f,
                         bwd_ms=ms_b, peak_above=peak)
        log(f"[autodiff] reshard {n}^3 f32 ({run}): d/du sum(v*v) = 2u bit "
            f"for bit; K1 forward {nf}, backward {nb} ({sorted(rec)}); "
            f"forward {ms_f:.2f} ms, backward {ms_b:.2f} ms; peak "
            f"{_gib(peak):.2f} GiB above u and its leaf")
        if nb <= 0:
            raise AssertionError(f"reshard gradient ({run}) launched K1 no "
                                 f"time backward")
        del leaf
    del u
    torch.cuda.empty_cache()
    return rows


def _grad_fft(torch, pat, k1, topo, acc, n, bwd_classes):
    """512^3 f32 plans over 3 components (each stage moves them around
    cuFFT with K1): c2c, the gradient of sum|F u|^2 against 2 N u
    (Parseval) within 1e-5 of its max; r2c, the gradient of
    sum(backward(forward(u)) * w) against w within 1e-5 of max|w|."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 41)
    rows = {}
    for run in ("c2c", "r2c"):
        real = run == "r2c"
        plan = pat.PencilFFTPlan(topo, (n, n, n), real=real,
                                 dtype=torch.float32 if real
                                 else torch.complex64)
        pen = plan.input_pencil
        shape = pen.padded_size_local(pat.MemoryOrder) + (3,)
        u = random_tensor(torch, shape, plan.dtype_physical, gen)
        w = random_tensor(torch, shape, torch.float32, gen) if real else None
        leaf = u.clone().requires_grad_()

        def fwd():
            x = pat.PencilArray(pen, leaf, (3,))
            if real:
                return (plan.backward(plan.forward(x)).data * w).sum()
            return _sq_norm(torch, plan.forward(x).data)

        _warm(torch, fwd)
        leaf.grad = None
        base = _peak_from(torch)
        loss, nf, _, ms_f = _k1_window(torch, k1, acc, fwd)
        _, nb, rec, ms_b = _k1_window(torch, k1, acc, loss.backward)
        peak = torch.cuda.max_memory_allocated() - base
        del loss
        want = w if real else (2.0 * n ** 3) * u
        scale = float(want.abs().max())
        err = max_abs_err(torch, leaf.grad, want) / scale
        del want
        for cls, c in rec.items():
            bwd_classes[cls] = bwd_classes.get(cls, 0) + c
        rows[run] = dict(fwd_launches=nf, bwd_launches=nb, fwd_ms=ms_f,
                         bwd_ms=ms_b, peak_above=peak, rel_err=err)
        what = ("d/du sum(roundtrip(u) * w) against w" if real else
                "d/du sum|F u|^2 against 2 N u (Parseval)")
        log(f"[autodiff] fft {n}^3 x 3 {run} f32: {what}, max error "
            f"{err:.3e} of its max (<= 1e-5); K1 forward {nf}, backward "
            f"{nb}; forward {ms_f:.2f} ms, backward {ms_b:.2f} ms; peak "
            f"{_gib(peak):.2f} GiB above the input")
        if not err <= 1e-5:
            raise AssertionError(f"{run} plan gradient off by {err}")
        if nb <= 0:
            raise AssertionError(f"{run} plan gradient launched K1 no time "
                                 f"backward")
        del u, w, leaf, plan
        torch.cuda.empty_cache()
    return rows


def _ns_loss(torch, pat, model, pen, dt):
    def loss(data):
        out = model.step(pat.PencilArray(pen, data, (3,)), dt)
        return _sq_norm(torch, out.data)
    return loss


def _ns_fd(torch, pat, models, k1, topo, acc, n, nu=0.05, dt=1e-2):
    """One f64 RK2 step at n^3: the gradient's directional derivative
    along a random real unit direction against a central difference,
    within 1e-4 (the JAX package's bar).  The step is 1e-6 of the
    state's norm: the loss grows as n^6, and the JAX test's 1e-5 at 8^3
    leaves a 64^3 difference to f64 cancellation (2.2e-4)."""
    model = models.NavierStokesSpectral(topo, n, viscosity=nu,
                                        dtype=torch.float64)
    uh0 = models.taylor_green(model)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 42)
    d = torch.randn(uh0.data.shape, dtype=torch.float64, generator=gen,
                    device="cuda")
    d /= d.norm()
    eps = 1e-6 * float(torch.linalg.vector_norm(uh0.data))
    loss = _ns_loss(torch, pat, model, uh0.pencil, dt)
    leaf = uh0.data.clone().requires_grad_()
    _k1_window(torch, k1, acc, lambda: loss(leaf).backward())
    # PyTorch's gradient of a real loss is dL/dx + i dL/dy
    dd = float((leaf.grad * d).real.sum())
    with torch.no_grad():
        fd = (float(loss(uh0.data + eps * d))
              - float(loss(uh0.data - eps * d))) / (2 * eps)
    rel = abs(dd - fd) / abs(fd)
    log(f"[autodiff] NS {n}^3 f64, one RK2 step: directional derivative "
        f"{dd:.12e} against the central difference {fd:.12e} (step "
        f"{eps:.3e}), rel {rel:.3e} (<= 1e-4)")
    if not rel <= 1e-4:
        raise AssertionError(f"NS f64 gradient off the central difference "
                             f"by {rel}")
    return dict(n=n, dd=dd, fd=fd, eps=eps, rel=rel)


def _ns_grad(torch, pat, models, k1, acc, model, uh0, remat, dt=5e-3):
    """The gradient of sum|step(uh).data|^2 (eager, or under
    ``torch.utils.checkpoint``): the gradient, K1 forward and backward
    (recomputation included), the classes launched backward, ms, peak."""
    from torch.utils.checkpoint import checkpoint

    loss_fn = _ns_loss(torch, pat, model, uh0.pencil, dt)
    leaf = uh0.data.clone().requires_grad_()

    def fwd():
        if remat:
            return checkpoint(loss_fn, leaf, use_reentrant=False)
        return loss_fn(leaf)

    _warm(torch, fwd)
    leaf.grad = None
    base = _peak_from(torch)
    loss, nf, _, ms_f = _k1_window(torch, k1, acc, fwd)
    _, nb, rec, ms_b = _k1_window(torch, k1, acc, loss.backward)
    peak = torch.cuda.max_memory_allocated() - base
    return leaf.grad, dict(fwd_launches=nf, bwd_launches=nb, fwd_ms=ms_f,
                           bwd_ms=ms_b, peak_above=peak), rec


def _plain_moves(k1):
    """Every K1 call on the card as its plain version (phase 2's
    yardstick): ``permute._check`` answers ``"cpu"`` after its checks."""
    check = k1._check

    def plain(x, out=None, out_shape=None):
        check(x, out, out_shape)
        return "cpu"

    k1._check = plain
    return check


def _grad_ns(torch, pat, models, k1, topo, paths, n, n_fd, bwd_classes):
    """The NS step's gradient: f64 at n_fd^3 against finite differences;
    eager (at 512^3 where 8 times the 256^3 run's peak stays under
    ``NS_EAGER_LIMIT``, else at 256^3); at n^3 f32 under
    ``torch.utils.checkpoint``, held bit for bit to the same gradient
    with the plain moves."""
    res = {"fd": _ns_fd(torch, pat, models, k1, topo, paths["grad_ns"],
                        n_fd)}
    eager = {}
    half = n // 2
    for m in ((half, n) if half >= 16 else (n,)):
        if m > half and half in eager \
                and eager[half]["peak_above"] * 8 >= NS_EAGER_LIMIT:
            log(f"[autodiff] NS eager gradient at {n}^3 reckoned at "
                f"{_gib(eager[half]['peak_above'] * 8):.2f} GiB above the "
                f"state (8 x the {half}^3 peak), over "
                f"{_gib(NS_EAGER_LIMIT):.0f}: run at {half}^3 only")
            break
        model = models.NavierStokesSpectral(topo, m, viscosity=1e-2,
                                            dtype=torch.float32)
        uh0 = models.taylor_green(model)
        g, row, rec = _ns_grad(torch, pat, models, k1, paths["grad_ns"],
                               model, uh0, False)
        for cls, c in rec.items():
            bwd_classes[cls] = bwd_classes.get(cls, 0) + c
        eager[m] = row
        log(f"[autodiff] NS {m}^3 f32 eager gradient: K1 forward "
            f"{row['fwd_launches']}, backward {row['bwd_launches']}; "
            f"forward {row['fwd_ms']:.2f} ms, backward {row['bwd_ms']:.2f} "
            f"ms; peak {_gib(row['peak_above']):.2f} GiB above the state")
        if row["bwd_launches"] <= 0:
            raise AssertionError("NS eager gradient launched K1 no time "
                                 "backward")
        del model, uh0, g
        torch.cuda.empty_cache()
    res["eager"] = eager
    model = models.NavierStokesSpectral(topo, n, viscosity=1e-2,
                                        dtype=torch.float32)
    uh0 = models.taylor_green(model)
    g, row, rec = _ns_grad(torch, pat, models, k1,
                           paths["grad_ns_checkpoint"], model, uh0, True)
    for cls, c in rec.items():
        bwd_classes[cls] = bwd_classes.get(cls, 0) + c
    check = _plain_moves(k1)
    try:
        g_plain, twin, _ = _ns_grad(torch, pat, models, k1, _path(), model,
                                    uh0, True)
    finally:
        k1._check = check
    if twin["fwd_launches"] or twin["bwd_launches"]:
        raise AssertionError("the plain-move twin launched K1")
    same = same_bits(torch, g, g_plain)
    diff = 0.0 if same else max_abs_err(torch, g, g_plain) / float(
        g_plain.abs().max())
    row.update(same_as_plain=same, rel_diff_plain=diff,
               plain_fwd_ms=twin["fwd_ms"], plain_bwd_ms=twin["bwd_ms"],
               plain_peak_above=twin["peak_above"],
               finite=bool(torch.isfinite(torch.view_as_real(g)).all()))
    res["checkpoint"] = row
    log(f"[autodiff] NS {n}^3 f32 gradient under torch.utils.checkpoint: "
        f"K1 forward {row['fwd_launches']}, backward {row['bwd_launches']} "
        f"(recomputation included); forward {row['fwd_ms']:.2f} ms, "
        f"backward {row['bwd_ms']:.2f} ms; peak "
        f"{_gib(row['peak_above']):.2f} GiB above the state; the same "
        f"gradient with the plain moves: "
        + ("bit-identical" if same else f"NOT bit-identical, max diff "
           f"{diff:.3e} of max|g| (bar 1e-6)")
        + f" ({twin['fwd_ms']:.2f} + {twin['bwd_ms']:.2f} ms, peak "
        f"{_gib(twin['peak_above']):.2f} GiB)")
    if not row["finite"]:
        raise AssertionError("NS gradient is not finite")
    if not diff <= 1e-6:
        raise AssertionError(f"NS gradient off its plain-move twin by {diff}")
    if row["bwd_launches"] <= 0:
        raise AssertionError("NS checkpointed gradient launched K1 no time "
                             "backward")
    del model, uh0, g, g_plain
    torch.cuda.empty_cache()
    return res


def _int_view(torch, t):
    """``t``'s bits as integers of its element size (a complex tensor as
    its real view: one more trailing dim)."""
    if t.is_complex():
        t = torch.view_as_real(t)
    if t.dtype == torch.bool:
        return t.view(torch.uint8)
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


def _logical_bits(torch, x):
    """The logical-order view of a (1, 1) array's block, as bits."""
    from pencilarrays_tpu_torch.parallel.arrays import _inv_axes

    d = _int_view(torch, x.data)
    return d.permute(_inv_axes(x.pencil, d.dim() - x.pencil.ndims))


def _same_logical(torch, a, b) -> bool:
    return torch.equal(_logical_bits(torch, a), _logical_bits(torch, b))


CYCLE_DTYPES = ("float16", "int16", "int64", "uint8", "bool", "complex128")


def _dtype_cycles(torch, pat, k1, topo, acc, n):
    """The n^3 x->y->z->y->x cycle (phase 3's pencils, AllToAll) in each
    dtype of ``CYCLE_DTYPES``: every hop's logical content equal to its
    input's bit for bit (so the round trip too), ms (the hops alone) and
    K1 launches by instance."""
    shape = (n, n, n)
    px = pat.Pencil(topo, shape, (1, 2), permutation=pat.Permutation(1, 2, 0))
    py = pat.Pencil(topo, shape, (0, 2), permutation=pat.Permutation(0, 2, 1))
    pz = pat.Pencil(topo, shape, (0, 1))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 43)
    rows = {}
    for name in CYCLE_DTYPES:
        dtype = getattr(torch, name)
        gc.collect()
        torch.cuda.empty_cache()
        mem = px.padded_size_local(pat.MemoryOrder)
        data = (torch.randint(0, 2, mem, generator=gen, device="cuda").bool()
                if dtype == torch.bool else
                random_tensor(torch, mem, dtype, gen))
        v = pat.PencilArray(px, data)
        del data
        base = _peak_from(torch)
        by0 = dict(acc["launches_by_instance"])
        ms, launches = 0.0, 0
        for i, pen in enumerate((py, pz, py, px)):
            w, nl, _, t = _k1_window(
                torch, k1, acc, lambda: pat.transpose(v, pen))
            ms += t
            launches += nl
            if not _same_logical(torch, v, w):
                raise AssertionError(f"{name} cycle: hop {i + 1} moved bits")
            v = w
        peak = torch.cuda.max_memory_allocated() - base
        del v, w
        by = {i: c - by0.get(i, 0)
              for i, c in acc["launches_by_instance"].items()
              if c != by0.get(i, 0)}
        rows[name] = dict(ms=ms, launches=launches, by_instance=by,
                          peak_above=peak)
        log(f"[autodiff] dtypes: {n}^3 {name} x->y->z->y->x, every hop "
            f"bit-identical (so the round trip); {ms:.2f} ms over the four "
            f"hops; K1 launches {launches}, by instance {by}; peak "
            f"{_gib(peak):.2f} GiB above the input")
        if launches <= 0:
            raise AssertionError(f"{name} cycle launched K1 no time")
    torch.cuda.empty_cache()
    return rows


def _narrow_reductions(torch, pat, topo, shape=(257, 255, 253)):
    """maximum and minimum of f16, bf16, int16 and uint8 arrays of a
    ragged shape against the same values reduced on the host."""
    pen = pat.Pencil(topo, shape, (1, 2))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 44)
    rows = {}
    for name in ("float16", "bfloat16", "int16", "uint8"):
        data = random_tensor(torch, pen.padded_size_local(pat.MemoryOrder),
                             getattr(torch, name), gen)
        x = pat.PencilArray(pen, data)
        got = (float(pat.ops.maximum(x)), float(pat.ops.minimum(x)))
        host = data.cpu().float()
        want = (float(host.max()), float(host.min()))
        rows[name] = got
        if got != want:
            raise AssertionError(f"{name} max/min {got} != {want}")
    log(f"[autodiff] ragged {shape} maximum/minimum on the card equal the "
        f"host's: {rows}")
    return rows


def _topo3(torch, pat, k1, topo2, acc, n, shape4):
    """A (1, 1, 1) topology: M = N = 3, a transpose changing only the
    permutation and back, bit for bit; BASELINE config 4, a 4-D c64 array
    (M = 2, permuted pencils; 4 GiB at ``shape4``) transposed and back,
    bit for bit; one ``Pencil.similar``."""
    topo3 = pat.Topology((1, 1, 1))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 45)
    pen1 = pat.Pencil(topo3, (n, n, n))
    if pen1.decomposition != (0, 1, 2):
        raise AssertionError(f"default decomposition {pen1.decomposition}")
    pen2 = pen1.replace(permutation=pat.Permutation(1, 2, 0))
    pa = pat.Pencil(topo2, shape4, (1, 2),
                    permutation=pat.Permutation(2, 0, 3, 1))
    pb = pat.Pencil(topo2, shape4, (1, 3),
                    permutation=pat.Permutation(1, 3, 0, 2))
    rows = {}
    for run, p_from, p_to, dtype in (("m_eq_n", pen1, pen2, torch.float32),
                                     ("config4", pa, pb, torch.complex64)):
        x = pat.PencilArray(p_from, random_tensor(
            torch, p_from.padded_size_local(pat.MemoryOrder), dtype, gen))
        y, n1, _, t1 = _k1_window(torch, k1, acc,
                                  lambda: pat.transpose(x, p_to))
        back, n2, _, t2 = _k1_window(torch, k1, acc,
                                     lambda: pat.transpose(y, p_from))
        if not (_same_logical(torch, x, y)
                and same_bits(torch, back.data, x.data)):
            raise AssertionError(f"{run}: the transpose moved bits")
        nbytes = x.data.numel() * x.data.element_size()
        rows[run] = dict(shape=list(p_from.size_global()), gib=_gib(nbytes),
                         ms=[t1, t2], launches=[n1, n2])
        log(f"[autodiff] topo {run}: {p_from.size_global()} "
            f"{str(dtype).split('.')[-1]} ({_gib(nbytes):.2f} GiB) "
            f"{p_from.decomposition}/{p_from.permutation} -> "
            f"{p_to.decomposition}/{p_to.permutation} and back, bit for "
            f"bit; {t1:.2f} + {t2:.2f} ms, K1 launches {n1} + {n2}")
        del x, y, back
    sim = pa.similar(global_shape=(64, 64, 64, 64))
    if (sim.size_global() != (64, 64, 64, 64)
            or sim.decomposition != pa.decomposition
            or sim.permutation != pa.permutation
            or sim.topology is not pa.topology or pa.similar() != pa):
        raise AssertionError(f"Pencil.similar gave {sim!r}")
    log(f"[autodiff] Pencil.similar: {sim!r}")
    torch.cuda.empty_cache()
    return rows


def _k1_backward_bits(torch, k1, classes):
    """K1's autograd permute at every permute class the gradient paths
    launched backward: its backward (K1 with the inverse axes) against the
    plain inverse permute of the same cotangent, bit for bit."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 46)
    seen = []
    for cls in classes:
        kind, shape, axes, _, _, dname, _ = _k1_cls(cls)
        if kind != "permute" or (shape, axes, dname) in seen:
            continue
        seen.append((shape, axes, dname))
        dtype = getattr(torch, dname)
        x = random_tensor(torch, shape, dtype, gen).requires_grad_()
        y = k1.permute(x, axes)
        if y.grad_fn is None:
            raise AssertionError(f"K1 permute {cls} is not differentiable")
        g = random_tensor(torch, tuple(y.shape), dtype, gen)
        y.backward(g)
        inv = tuple(axes.index(i) for i in range(len(axes)))
        if not same_bits(torch, x.grad, k1.permute_plain(g, inv)):
            raise AssertionError(f"K1 backward at {cls} differs from the "
                                 f"plain inverse permute")
        del x, y, g
    log(f"[autodiff] K1's backward bit-identical to the plain inverse "
        f"permute at the {len(seen)} permute classes the gradient paths "
        f"launched backward: {seen}")
    if not seen:
        raise AssertionError("the gradient paths launched no K1 permute "
                             "backward")
    torch.cuda.empty_cache()
    return [list(s) for s in seen]


def phase_autodiff(torch, pat, models, k1, n_reshard=1024, n_fft=512,
                   n_ns=512, n_fd=64, n_cycle=1024, n_topo=512,
                   shape4=(256, 256, 128, 64)):
    """Phase 5i: gradients on the card, K1 forward and backward (each
    path counted from 0 just before its run): ``grad_reshard``,
    ``grad_fft``, ``grad_ns`` (f64 finite differences and the eager f32
    gradient), ``grad_ns_checkpoint``; the dtypes the cycle never ran
    (``dtypes``), the narrow ragged reductions, a 3-D topology and
    BASELINE config 4 (``topo3``); then K1's backward against the plain
    inverse permute at every permute class launched backward."""
    t0 = time.perf_counter()
    gc.collect()
    torch.backends.cuda.cufft_plan_cache.clear()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    log(f"[autodiff] free on the card at the phase's start {_gib(free):.2f} "
        f"of {_gib(total):.2f} GiB")
    paths = {name: _path() for name in AUTODIFF_PATHS}
    bwd = {}
    # one topology for the phase: each makes NCCL communicators, whose
    # device memory the process keeps
    topo = pat.Topology((1, 1))
    res = {"reshard": _grad_reshard(torch, pat, k1, topo,
                                    paths["grad_reshard"], n_reshard, bwd),
           "fft": _grad_fft(torch, pat, k1, topo, paths["grad_fft"], n_fft,
                            bwd),
           "ns": _grad_ns(torch, pat, models, k1, topo, paths, n_ns, n_fd,
                          bwd),
           "dtypes": _dtype_cycles(torch, pat, k1, topo, paths["dtypes"],
                                   n_cycle),
           "narrow_reductions": _narrow_reductions(torch, pat, topo),
           "topo3": _topo3(torch, pat, k1, topo, paths["topo3"], n_topo,
                           shape4)}
    res["k1_backward_classes"] = _k1_backward_bits(torch, k1, bwd)
    for run, a in paths.items():
        if a["launches"] <= 0:
            raise AssertionError(f"the {run} path launched K1 no time")
    res["paths"] = paths
    res["seconds"] = time.perf_counter() - t0
    log(f"[autodiff] phase 5i took {res['seconds']:.1f} s; K1 launches by "
        f"path " + json.dumps({run: a["launches"]
                               for run, a in paths.items()}))
    return res


# -- phase 5j: the user entry points (examples/ and entry.py) ----------------

EXAMPLES_DIR = "chip_smoke_examples"
# each example once more at a small shape, on the card and on the CPU
# (launching no kernel), held together: fields within 1e-5 of
# the CPU's largest magnitude (the NS state within 1e-4: phase 5's 64^3
# bar), the attention schemes per row (the example's TOL: phase 7's
# bars), the loss series per step (1e-4 f32, 2^-6 bf16), bits where
# only data moves, and the quickstart's normal fill within 1e-5 (its
# Box-Muller transcendentals are the CPU's and the card's own)
EXAMPLES_SMALL = {
    "quickstart": {},
    "gradient_spectral": {"shape": (64, 64, 64), "dtype": "float32"},
    "navier_stokes": {"n": 64},
    "adjoint_optimization": {"shape": (64, 64, 64)},
    "heat_stencil": {"n": 64},
    "checkpoint_collections": {"shape": (64, 64, 64)},
    "observability_demo": {"shape": (64, 64, 64)},
    "sequence_parallel_attention": {"seq": 256},
    "long_context_training": {"seq": 256},
}
EXAMPLES_CARD_CPU = {
    "quickstart": [("u", 1e-5), ("grid", 1e-5), ("numpy_sum", 1e-5)],
    "gradient_spectral": [("dfdx", 1e-5)],
    "navier_stokes": [("velocity", 1e-4), ("continued", 1e-4),
                      ("energy_continued", 1e-4)],
    "adjoint_optimization": [("u", 1e-5), ("losses", "losses")],
    "heat_stencil": [("u", 1e-5), ("exact", 1e-5)],
    "checkpoint_collections": [("binary_restart", "bits"),
                               ("managed_restart", "bits")],
    "observability_demo": [("event_kinds", "equal")],
    "sequence_parallel_attention": [
        (f"{s}_{d}", "rows") for s in ("ulysses", "ring", "zigzag")
        for d in ("float32", "bfloat16")],
    "long_context_training": [("losses_float32", "losses"),
                              ("losses_bfloat16", 2 ** -6)],
}

# the kernels each path of phase 5j must launch on one card.  The
# spectral gradient's and the adjoint's scalar r2c plans on a one-rank
# topology make no hop and move no extra dim (as the JAX plan makes
# none on one device): no kernel there; their hops run on the CPU tests'
# 8 gloo ranks
EXAMPLES_KERNELS = {
    "examples.quickstart": ("k1",), "examples.gradient_spectral": (),
    "examples.navier_stokes": ("k1",), "examples.adjoint_optimization": (),
    "examples.heat_stencil": ("k1",),
    "examples.checkpoint_collections": ("k1",),
    "examples.observability_demo": ("k1",),
    "examples.sequence_parallel_attention": ("k1", "k2"),
    "examples.long_context_training": ("k2", "k3", "k4"),
    "entry.dryrun": ("k1",)}

def _example_held(np, name, key, how, card, cpu):
    """The card's value of ``key`` against the CPU's; the error (0 for
    bits and equality), or raise."""
    a, b = card[key], cpu[key]
    if how == "equal":
        if a != b:
            raise AssertionError(f"{name} {key}: card {a} != CPU {b}")
        return 0.0
    if how == "losses":
        # each step within 1e-4 of its loss; a loss below 1e-6 of the
        # first is at the f32 round-off floor of its sum: within 1e-10 of
        # the first (tests/test_torch_examples.py's rule)
        errs = [abs(x - y) / (y if y >= 1e-6 * b[0] else 1e6 * b[0])
                for x, y in zip(a, b)]
        if len(a) != len(b) or not max(errs) <= 1e-4:
            raise AssertionError(f"{name} {key}: card {a} vs CPU {b}")
        return max(errs)
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        raise AssertionError(f"{name} {key}: shape {a.shape} vs {b.shape}")
    if how == "bits":
        if not np.array_equal(a, b):
            raise AssertionError(f"{name} {key}: card bits != CPU bits")
        return 0.0
    if how == "rows":
        from pencilarrays_tpu_torch.examples import \
            sequence_parallel_attention as spa
        err, how = (spa.row_rel_err(a, b),
                                      spa.TOL[key.rsplit("_", 1)[1]])
    else:
        err = float(np.abs(a - b).max() / max(float(np.abs(b).max()),
                                              1e-30))
    if not err <= how:
        raise AssertionError(f"{name} {key}: card vs CPU {err} > {how}")
    return err


def phase_examples(torch, pat, k1, flash):
    """Phase 5j: the repo's user entry points on the card.  Each example
    of ``pencilarrays_tpu_torch/examples`` at its card default (its
    ``SIZES``; every count reset just before it, read just after: the
    path ``examples.<name>``), then ``entry()`` and ``dryrun(1)`` (path
    ``entry.dryrun``); then each example at a small shape on the card
    against the same on the CPU, which must launch no kernel.  Files go
    to ``EXAMPLES_DIR`` (deleted at the end)."""
    import importlib
    import shutil

    import numpy as np
    from pencilarrays_tpu_torch import entry as port_entry
    from pencilarrays_tpu_torch.examples import EXAMPLES, _launch

    t0 = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    d = os.path.join(root, EXAMPLES_DIR)
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    old_tmp = tempfile.tempdir
    tempfile.tempdir = d          # the examples' temporary directories
    paths, recorded = {}, {}
    try:
        for name in EXAMPLES:
            mod = importlib.import_module(
                f"pencilarrays_tpu_torch.examples.{name}")
            kw = ({"workdir": os.path.join(d, "obs_card")}
                  if name == "observability_demo" else {})
            torch.cuda.synchronize()
            _reset_counts(k1, flash)
            k1.recorded = {}
            t1 = time.perf_counter()
            res = mod.run(**kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
            n = _counts(k1, flash)
            recorded[f"examples.{name}"], k1.recorded = k1.recorded, None
            paths[f"examples.{name}"] = dict(n, seconds=wall)
            checks = {k: v for k, v in _launch.scalars(res).items()
                      if not isinstance(v, list) or len(v) <= 8}
            log(f"[examples] {name} {mod.SIZES}: {wall:.2f} s, checks "
                + json.dumps(checks) + f"; launches K1 {n['k1']} K2 "
                f"{n['k2']} K3 {n['k3']} K4 {n['k4']}")
            del res
            gc.collect()
            torch.cuda.empty_cache()
        # the driver entry points: the flagship step, the dry run of one
        torch.cuda.synchronize()
        _reset_counts(k1, flash)
        k1.recorded = {}
        t1 = time.perf_counter()
        fn, args = port_entry.entry()
        y = fn(*args)
        if y.shape != args[0].shape or not bool(
                torch.isfinite(torch.view_as_real(y)).all()):
            raise AssertionError("entry(): the step's output")
        dry = port_entry.dryrun(1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        if not dry["ok"]:
            raise AssertionError(f"dryrun(1): {dry}")
        n = _counts(k1, flash)
        recorded["entry.dryrun"], k1.recorded = k1.recorded, None
        paths["entry.dryrun"] = dict(n, seconds=wall)
        log(f"[examples] entry() step {tuple(y.shape)} finite, dryrun(1) "
            f"ok with no byte across ranks ({json.dumps(dry['forward'])}): "
            f"{wall:.2f} s; launches K1 {n['k1']} K2 {n['k2']}")
        # the small runs record no time; the CPU's launch no kernel
        for name, held in EXAMPLES_CARD_CPU.items():
            mod = importlib.import_module(
                f"pencilarrays_tpu_torch.examples.{name}")
            small = {}
            for dev in ("card", "cpu"):
                kw = dict(EXAMPLES_SMALL[name])
                if name == "observability_demo":
                    kw["workdir"] = os.path.join(d, f"obs_small_{dev}")
                _reset_counts(k1, flash)
                small[dev] = mod.run(device=None if dev == "card" else dev,
                                     **kw)
            n = _counts(k1, flash)
            if any(n[k] for k in ("k1", "k2", "k3", "k4")):
                raise AssertionError(f"{name} on the CPU launched {n}")
            errs = {key: _example_held(np, name, key, how, small["card"],
                                       small["cpu"]) for key, how in held}
            log(f"[examples] {name} {EXAMPLES_SMALL[name]} card vs CPU: "
                + json.dumps(errs))
    finally:
        tempfile.tempdir = old_tmp
        shutil.rmtree(d, ignore_errors=True)
    seconds = time.perf_counter() - t0
    log(f"[examples] phase 5j took {seconds:.1f} s; launches by path "
        + json.dumps({p: {k: n[k] for k in ("k1", "k2", "k3", "k4")}
                      for p, n in paths.items()}))
    for p, keys in EXAMPLES_KERNELS.items():
        if min((paths[p][k] for k in keys), default=1) <= 0:
            raise AssertionError(f"the {p} path launched {paths[p]}")
    return dict(paths=paths, recorded=recorded, seconds=seconds)


# Tolerances of K2–K4 against their plain versions.  Each row of a tensor
# (its last dim: one query or key position of one head·batch slice) is
# held relative to its own largest |plain| (see _rel_err).  The kernels
# and the plain versions (cuBLAS matmuls over key chunks) sum in different
# orders; in f32 that moves a row by ~1e-6 of its scale in the forward and
# a few 1e-6 in the backward, a difference of two sums.  In bf16 each side
# rounds the output once, which is at most one bf16 ulp (2^-7 of the
# element) apart, and the forward rounds P to bf16 against running maxima
# that differ between a kernel tile and a plain chunk: 2^-6 allows one ulp
# for each.  The wgmma backward also rounds P and dS to bf16 where they
# become A fragments (the plain version keeps them in f32): each term of
# a row's sum then carries an independent relative error of at most 2^-9,
# ~2^-9/sqrt(3) on average, so over many terms the row moves by
# ≲ 2^-9/sqrt(3) of its scale; the output's own rounding (one ulp, 2^-7)
# dominates, and the bar stays 2^-6.
FLASH_TOL = {("fwd", "float32"): 1e-5, ("bwd", "float32"): 5e-5,
             ("fwd", "bfloat16"): 2 ** -6, ("bwd", "bfloat16"): 2 ** -6}
FLASH_OFFSETS = [(False, 0, 0), (True, 0, 0), (True, 5, 0), (True, 0, 3),
                 (True, 17, 9)]


def _rel_err(torch, got, want, rows=None, terms=None) -> float:
    """Worst error of ``got`` against ``want``, each row relative to its
    own max|want|: a row is the last dim, and its scale is floored at
    1e-3 max|want| so that a row of zeros compares nearly absolutely.
    ``rows`` (a boolean mask along dim 0) selects the rows compared.
    ``terms`` (one value per element or per row of ``got``) is the largest
    term of the sum behind each element: a row is held relative to the
    larger of that and its own max|want|, so that a row whose sum cancels
    (its exact value 0 or nearly) is held to the rounding of its terms,
    which no two summation orders share (see _bwd_terms)."""
    got, want = got.double(), want.double()
    if terms is not None:
        terms = terms.double().reshape(got.shape[:-1] + (-1,))
    if rows is not None:
        got, want = got[rows], want[rows]
        terms = None if terms is None else terms[rows]
    floor = 1e-3 * float(want.abs().max()) or 1.0
    scale = want.abs().amax(dim=-1, keepdim=True)
    if terms is not None:
        scale = torch.maximum(scale, terms.amax(dim=-1, keepdim=True))
    return float(((got - want).abs() / scale.clamp_min(floor)).max())


def _bwd_terms(torch, flash, q, k, v, do, L, D, *, causal, q_offset,
               kv_offset):
    """The largest term of each row of dq and of dk, with dS_ij = P_ij ·
    (Σ_e dO_ie v_je - D_i) expanded: dq_i = scale · Σ_j dS_ij K_j has terms
    of at most scale · max_j P_ij · max(|dO_i|·|v_j|, |D_i|) · |K_j|
    (|x| the largest |element|), and dk_j = scale · Σ_i dS_ij Q_i those
    with |Q_i|.  A row that sees one key cancels wholly (P = 1, D = dP:
    dq is 0 in exact arithmetic) and one that a key dominates nearly; such
    a row is the rounding of these terms, which no two summation orders
    share.  q/k/v/do ``(S, H, *b, D)``, folded ``L, D`` ``(N, Sq)`` (the
    residuals both sides are given); returns ``(Sq, N)`` and ``(Skv, N)``
    f32, one folded slice at a time (at S = 4096 a slice's score block is
    64 MiB)."""
    qf, kf, vf, dof = (flash._fold(x).float() for x in (q, k, v, do))
    sq, n, d = qf.shape
    skv = kf.shape[0]
    scale = 1.0 / math.sqrt(d)
    pos = q_offset + torch.arange(sq, device=qf.device)
    cols = kv_offset + torch.arange(skv, device=qf.device)
    valid = (pos[:, None] >= cols[None, :]) if causal else None
    qm, km, vm, dom = (x.abs().amax(-1) for x in (qf, kf, vf, dof))  # (S, N)
    tq = torch.zeros((sq, n), device=qf.device)
    tk = torch.zeros((skv, n), device=qf.device)
    for h in range(n):
        p = torch.exp(qf[:, h] @ kf[:, h].t() * scale - L[h, :, None])
        if valid is not None:
            p = torch.where(valid, p, 0.0)
        t = p * torch.maximum(dom[:, h, None] * vm[None, :, h],
                              D[h, :, None].abs())
        tq[:, h] = (t * km[None, :, h]).amax(-1) * scale
        tk[:, h] = (t * qm[:, h, None]).amax(0) * scale
    return tq, tk


def _bwd_launched(flash, fn, dtypes, what):
    """``fn()``, which must launch K3 and K4 once each, by the instance
    ``bwd_instance`` picks for the head dim and the q, k, v, dO dtypes."""
    by0 = [dict(flash.launches_dq_by_instance),
           dict(flash.launches_dkv_by_instance)]
    out = fn()
    want = flash.bwd_instance(*dtypes)
    for kernel, before, now in zip(
            ("K3", "K4"), by0, (flash.launches_dq_by_instance,
                                flash.launches_dkv_by_instance)):
        got = {i: now[i] - before[i] for i in before}
        if got != {i: int(i == want) for i in got}:
            raise AssertionError(f"{what}: {kernel} launches by instance "
                                 f"{got}, expected one {want}")
    return out


def flash_compare(torch, flash, q, k, v, causal, q_off, kv_off, own=None):
    """K2 (three modes), K3 + K4 (full and partials) against the plain
    versions on one case; returns {"fwd": err, "bwd": err}, each the worst
    per-row relative error (_rel_err) of the tensors of that direction.
    The rows of m (a score: its terms scale·q_d·k_d are at most
    scale·max|q_i|·max|k|), dq and dk (_bwd_terms) are held relative to
    the larger of their own max|plain| and their largest term; ``own``, a
    dict, keeps the worst rows of each direction relative to their own
    max|plain| alone.  The partials backward runs with dO in q's dtype (as
    the ring backwards pass it) and, for a bf16 q, also widened to f32;
    each K3/K4 call must launch the instance ``bwd_instance`` picks."""
    sq = q.shape[0]
    rows = (q_off + torch.arange(sq, device=q.device)) >= kv_off
    kw = dict(causal=causal, q_offset=q_off, kv_offset=kv_off)
    errs = {"fwd": [], "bwd": []}

    def held(key, got, want, rows=None, terms=None):
        errs[key].append(_rel_err(torch, got, want, rows, terms))
        if own is not None and terms is not None:
            own[key] = max(own.get(key, 0.0),
                           _rel_err(torch, got, want, rows))

    d = q.shape[-1]
    m_terms = (q.float().abs().amax(-1) * float(k.float().abs().max())
               / math.sqrt(d))                                # (Sq, H, B)
    out, (m, l) = flash.flash_attention_fwd(q, k, v, return_stats=True, **kw)
    out_p, (m_p, l_p) = flash.flash_attention_fwd_plain(
        q, k, v, return_stats=True, **kw)
    if not bool(torch.isfinite(out.float()).all()):
        raise AssertionError("K2 output is not finite")
    held("fwd", out, out_p, rows)
    held("fwd", m.t(), m_p.t(), rows, m_terms)
    held("fwd", l.t(), l_p.t(), rows)
    held("fwd", flash.flash_attention_fwd(q, k, v, **kw), out_p, rows)
    parts = flash.flash_attention_fwd(q, k, v, partials=True, **kw)
    parts_p = flash.flash_attention_fwd_plain(q, k, v, partials=True, **kw)
    for a, b, t in zip(parts[:2], parts_p[:2], (m_terms, None)):
        held("fwd", a.movedim(-1, 0), b.movedim(-1, 0), rows, t)  # m, l
    held("fwd", parts[2], parts_p[2], rows)
    # the backward from the SAME residuals on both sides; a zero
    # cotangent on rows with no visible key, as a loss over defined
    # outputs has
    gen = torch.Generator(device=q.device).manual_seed(SEED + 7)
    do = torch.randn(q.shape, generator=gen, device=q.device)
    do = (do * rows.view(-1, *([1] * (q.dim() - 1)))).to(q.dtype)
    what = (f"bwd d={d} {q.dtype}/{k.dtype}/{v.dtype} causal={causal} "
            f"offsets=({q_off},{kv_off})")
    L, D = flash.residuals(out_p, do, m_p, l_p)
    terms = _bwd_terms(torch, flash, q, k, v, do, L, D, **kw) + (None,)
    got = _bwd_launched(flash, lambda: flash.flash_attention_bwd(
        q, k, v, out_p, do, m_p, l_p, **kw),
        (d, q.dtype, k.dtype, v.dtype, do.dtype), what)
    want = flash.flash_attention_bwd_plain(q, k, v, out_p, do, m_p, l_p, **kw)
    for a, b, t in zip(got, want, terms):
        held("bwd", a, b, terms=t)
    h, b = q.shape[1], q.shape[2]
    L, D = L.reshape(h, b, sq), D.reshape(h, b, sq)
    for g in [do] + ([do.float()] if do.dtype != torch.float32 else []):
        got = _bwd_launched(
            flash, lambda: flash.flash_attention_bwd_partials(
                q, k, v, g, L, D, **kw),
            (d, q.dtype, k.dtype, v.dtype, g.dtype), f"{what} partials dO "
            f"{g.dtype}")
        want = flash.flash_attention_bwd_partials_plain(q, k, v, g, L, D,
                                                        **kw)
        for a, b, t in zip(got, want, terms):
            held("bwd", a, b, terms=t)
    return {key: max(e) for key, e in errs.items()}


def _ring_emulation(torch, flash, merge, dtype, blk, H, D, P=4):
    """The naive causal ring of P ranks at kernel level on one card: per
    rank, P partials calls with each round's offsets, merged, against one
    call over the whole sequence; per rank, bwd_partials over the P blocks
    (dq summed, dk/dv per block) against one full bwd_partials call."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    S = P * blk
    q, k, v = rnd(S, H, 1, D), rnd(S, H, 1, D), rnd(S, H, 1, D)
    fwd, bwd = [], []
    for me in range(P):
        qb = q[me * blk:(me + 1) * blk]
        carry = None
        for r in range(P):
            j = (me - r) % P
            part = flash.flash_attention_fwd(
                qb, k[j * blk:(j + 1) * blk], v[j * blk:(j + 1) * blk],
                causal=True, q_offset=me * blk, kv_offset=j * blk,
                partials=True)
            carry = part if carry is None else merge(carry, part)
        full = flash.flash_attention_fwd(qb, k, v, causal=True,
                                         q_offset=me * blk, partials=True)
        out = flash.normalize(carry[1], carry[2], torch.float32)
        out_full = flash.normalize(full[1], full[2], torch.float32)
        fwd.append(_rel_err(torch, out, out_full))
        do = rnd(blk, H, 1, D)   # the cotangent in q's dtype, as the ring
        L, Drow = flash.residuals(out_full, do, full[0].reshape(H, blk),
                                  full[1].reshape(H, blk))
        L, Drow = L.reshape(H, 1, blk), Drow.reshape(H, 1, blk)
        want = flash.flash_attention_bwd_partials(
            qb, k, v, do, L, Drow, causal=True, q_offset=me * blk)
        dq = torch.zeros_like(want[0])
        for j in range(P):
            g = flash.flash_attention_bwd_partials(
                qb, k[j * blk:(j + 1) * blk], v[j * blk:(j + 1) * blk], do,
                L, Drow, causal=True, q_offset=me * blk, kv_offset=j * blk)
            dq += g[0]
            for a, w in zip(g[1:], want[1:]):
                bwd.append(_rel_err(torch, a, w[j * blk:(j + 1) * blk]))
        bwd.append(_rel_err(torch, dq, want[0]))
    return max(fwd), max(bwd)


def _zigzag_emulation(torch, flash, merge, pairs, dtype, b, H, D, P=4):
    """The causal zigzag ring of P ranks at kernel level on one card.  Per
    rank, the partials calls of every round's pairs (``pairs`` is the
    schedule ring_attention runs, models.attention._zigzag_pairs), merged
    per q half, against one call of that half over the whole sequence;
    the bwd_partials of the same pairs, dq summed per q half against the
    full call's, and dk/dv summed per key block over all ranks against the
    full calls' sum."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def blk(x, i):
        return x[i * b:(i + 1) * b]

    S = 2 * P * b
    q, k, v = rnd(S, H, 1, D), rnd(S, H, 1, D), rnd(S, H, 1, D)
    f32 = torch.float32
    dk, dv, dk_full, dv_full = (torch.zeros((S, H, 1, D), dtype=f32,
                                            device="cuda") for _ in range(4))
    fwd, bwd = [], []
    for me in range(P):
        own = (me, 2 * P - 1 - me)   # global blocks of the lo and hi halves
        rounds = []
        for r in range(P):
            j = (me - r) % P          # the sender of this round's k/v
            held = (j, 2 * P - 1 - j)
            for qh, kh, qo, ko in pairs(me, r, P, b):
                if (qo, ko) != (own[qh] * b, held[kh] * b):
                    raise AssertionError(f"zigzag pair offsets {qo, ko} of "
                                         f"rank {me} round {r}")
                rounds.append((qh, held[kh], qo, ko))
        stats = [None, None]
        for qh, kb, qo, ko in rounds:
            part = flash.flash_attention_fwd(
                blk(q, own[qh]), blk(k, kb), blk(v, kb), causal=True,
                q_offset=qo, kv_offset=ko, partials=True)
            stats[qh] = part if stats[qh] is None else merge(stats[qh], part)
        resid, dq = [], [None, None]
        for qh in (0, 1):
            qq = blk(q, own[qh])
            full = flash.flash_attention_fwd(qq, k, v, causal=True,
                                             q_offset=own[qh] * b,
                                             partials=True)
            out_full = flash.normalize(full[1], full[2], f32)
            fwd.append(_rel_err(torch, flash.normalize(
                stats[qh][1], stats[qh][2], f32), out_full))
            do = rnd(b, H, 1, D)
            L, Drow = flash.residuals(out_full, do, full[0].reshape(H, b),
                                      full[1].reshape(H, b))
            L, Drow = L.reshape(H, 1, b), Drow.reshape(H, 1, b)
            resid.append((do, L, Drow))
            want = flash.flash_attention_bwd_partials(
                qq, k, v, do, L, Drow, causal=True, q_offset=own[qh] * b)
            dq[qh] = [torch.zeros_like(want[0]), want[0]]
            dk_full += want[1]
            dv_full += want[2]
        for qh, kb, qo, ko in rounds:
            g = flash.flash_attention_bwd_partials(
                blk(q, own[qh]), blk(k, kb), blk(v, kb), *resid[qh],
                causal=True, q_offset=qo, kv_offset=ko)
            dq[qh][0] += g[0]
            blk(dk, kb).add_(g[1])
            blk(dv, kb).add_(g[2])
        bwd += [_rel_err(torch, got, want) for got, want in dq]
    bwd += [_rel_err(torch, dk, dk_full), _rel_err(torch, dv, dv_full)]
    return max(fwd), max(bwd)


# q/k/v dtypes of the mixed cases: the kernels read each operand in its
# own dtype, so impl="auto" must take them
MIXED_DTYPES = [("bfloat16", "float32", "float32"),
                ("float32", "bfloat16", "float32"),
                ("float32", "float32", "bfloat16")]


def _mixed_check(torch, flash, attention, own=None):
    """q/k/v of mixed dtypes: K2–K4 against their plain versions
    (flash_compare, which keeps its own-scale rows in ``own``), and flash_attention under impl="auto" forward and
    backward, which must launch K2, K3 and K4 once each, give grads in the
    leaves' dtypes and the plain K2's output."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    errs = {"fwd": 0.0, "bwd": 0.0}
    for names in MIXED_DTYPES:
        q, k, v = (torch.randn((173, 2, 2, 64), generator=gen, device="cuda")
                   .to(getattr(torch, n)) for n in names)
        for key, err in flash_compare(torch, flash, q, k, v, True, 17,
                                      9, own).items():
            errs[key] = max(errs[key], err)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        n0 = (flash.launches_fwd, flash.launches_dq, flash.launches_dkv)
        out = attention.flash_attention(*leaves, causal=True)
        out.float().sum().backward()
        n = (flash.launches_fwd - n0[0], flash.launches_dq - n0[1],
             flash.launches_dkv - n0[2])
        if n != (1, 1, 1):
            raise AssertionError(f"mixed {names}: impl=auto launched {n}")
        if any(t.grad.dtype != t.dtype or not bool(torch.isfinite(
                t.grad.float()).all()) for t in leaves):
            raise AssertionError(f"mixed {names}: grads")
        errs["fwd"] = max(errs["fwd"], _rel_err(
            torch, out.detach(), flash.flash_attention_fwd_plain(
                q, k, v, causal=True)))
    return errs


def _tensor_core_edges(torch, flash, keep, dtype, own):
    """The tensor-core instances at their edges: in bf16 the wgmma ones of
    K2, K3 and K4, in f32 the tf32x3 ones of K3 and K4 (K2 runs simt).
    Head dims of each class and off its 64-column boxes or 16-row warp
    tiles, Sq below one warpgroup, Skv = 1, Skv off the key tile, k/v
    views with a storage offset (a row slice, as ring rounds pass, and a
    flat offset of one element, which the wrappers copy to a 16-byte
    boundary); every mode and offset case of flash_compare (its own-scale
    rows kept in ``own``, but at Skv = 1).  In bf16 K2
    launches only its wgmma instance and K3/K4 theirs, except the partials
    calls with an f32 dO (tf32x3); in f32 K3/K4 launch only tf32x3; as
    flash_compare checks call by call."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 14)
    name = str(dtype).split(".")[-1]
    inst = "wgmma" if dtype == torch.bfloat16 else "tf32x3"
    H, B = 3, 2

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def views(skv, d):
        rows = rnd(skv + 5, H, B, d)[5:]             # aligned storage offset
        flat = rnd(skv * H * B * d + 1)[1:].view(skv, H, B, d)   # off by 2 B
        return rows, flat

    by = _by_instance(flash)
    n0 = {key: dict(c) for key, c in by.items()}
    copies0 = flash.realigned_copies
    cases = 0
    for d in (40, 64, 96, 128, 200, 256):
        for sq, skv in ((237, 301), (50, 1), (50, 200)):
            q, k, v = rnd(sq, H, B, d), rnd(skv, H, B, d), rnd(skv, H, B, d)
            for causal, qo, ko in FLASH_OFFSETS:
                # at Skv = 1 dq and dk are 0 in exact arithmetic: no row
                # of theirs has a scale of its own to keep in ``own``
                for key, err in flash_compare(
                        torch, flash, q, k, v, causal, qo, ko,
                        own if skv > 1 else None).items():
                    keep(f"{inst} d={d} sq={sq} skv={skv} causal={causal} "
                         f"offsets=({qo},{ko})", key, name, err)
                cases += 1
        q = rnd(77, H, B, d)
        (kr, kf), (vr, vf) = views(130, d), views(130, d)
        for kk, vv, what in ((kr, vr, "row slice"), (kf, vf, "flat offset")):
            for causal, qo, ko in FLASH_OFFSETS[:3]:
                for key, err in flash_compare(torch, flash, q, kk, vv, causal,
                                              qo, ko, own).items():
                    keep(f"{inst} d={d} k/v {what} causal={causal}", key,
                         name, err)
                cases += 1
    torch.cuda.synchronize()
    n = {key: {i: by[key][i] - n0[key][i] for i in n0[key]} for key in by}
    copies = flash.realigned_copies - copies0
    want = {"k2": "wgmma" if inst == "wgmma" else "simt", "k3": inst,
            "k4": inst}
    # in bf16 the partials calls with an f32 dO take tf32x3
    allowed = {"k2": {want["k2"]}, "k3": {inst, "tf32x3"},
               "k4": {inst, "tf32x3"}}
    if any(n[k][want[k]] <= 0 or any(c for i, c in n[k].items()
                                     if i not in allowed[k]) for k in n):
        raise AssertionError(f"{name} edge cases launched instances {n}")
    if copies <= 0:
        raise AssertionError("the flat-offset k/v were not realigned")
    log(f"[flash] {inst} instances at their edges ({name}): {cases} cases "
        f"(d 40 64 96 128 200 256; (Sq, Skv) (237, 301) (50, 1) (50, 200); "
        f"k/v row slice and flat offset), launches by instance {n}"
        + (" (K3/K4 tf32x3: the partials calls with an f32 dO)"
           if inst == "wgmma" else "") + f", realigned copies {copies}")
    return cases


def phase_flash_check(torch, flash, attention):
    """K2–K4 against their plain versions on the card: three forward
    modes, full and partials backward, causal and not, ragged lengths,
    the offsets of FLASH_OFFSETS, rows with no visible key, f32 and bf16,
    head dims across every tile class; P = 4 naive and zigzag causal rings
    emulated at kernel level; flash_attention on q/k/v of mixed dtypes."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    worst = {}
    own = {}   # by (direction, dtype): the worst row by its own scale alone
    cases = 0
    sq, skv, H, B = 237, 301, 3, 2    # ragged: no tile size divides them

    def keep(what, key, name, err):
        tol = FLASH_TOL[(key, name)]
        if not err <= tol:
            raise AssertionError(f"{what} {key} {name}: rel err {err} > "
                                 f"{tol}")
        worst[(key, name)] = max(worst.get((key, name), 0.0), err)

    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for d in (40, 64, 128, 256, 520, 1024):
            def rnd(*shape):
                return torch.randn(shape, generator=gen,
                                   device="cuda").to(dtype)
            q, k, v = rnd(sq, H, B, d), rnd(skv, H, B, d), rnd(skv, H, B, d)
            for causal, qo, ko in FLASH_OFFSETS:
                errs = flash_compare(torch, flash, q, k, v, causal, qo, ko,
                                     own.setdefault(name, {}))
                for key, err in errs.items():
                    keep(f"flash d={d} causal={causal} offsets=({qo},{ko})",
                         key, name, err)
                cases += 1
        for blk in (192, 237):
            errs = _ring_emulation(torch, flash, attention._merge_partials,
                                   dtype, blk, 4, 64)
            for key, err in zip(("fwd", "bwd"), errs):
                keep(f"naive ring emulation blk={blk}", key, name, err)
        for b in (96, 119):
            errs = _zigzag_emulation(torch, flash, attention._merge_partials,
                                     attention._zigzag_pairs, dtype, b, 4, 64)
            for key, err in zip(("fwd", "bwd"), errs):
                keep(f"zigzag ring emulation b={b}", key, name, err)
    for key, err in _mixed_check(torch, flash, attention,
                                 own.setdefault("mixed", {})).items():
        keep("mixed dtypes", key, "bfloat16", err)
    for dtype in (torch.bfloat16, torch.float32):
        cases += _tensor_core_edges(torch, flash, keep, dtype, own.setdefault(
            str(dtype).split(".")[-1], {}))
    torch.cuda.synchronize()
    log(f"[flash] K2-K4 within tolerance of the plain versions on the card: "
        f"{cases} cases (Sq={sq}, Skv={skv}, H={H}, B={B}; d 40 64 128 256 "
        f"520 1024; f32 bf16; non-causal and causal offsets "
        f"{[o[1:] for o in FLASH_OFFSETS[1:]]}; out, return_stats, partials, "
        f"bwd, bwd_partials) + P=4 naive and zigzag causal rings emulated at "
        f"kernel level + flash_attention on mixed q/k/v dtypes "
        f"{MIXED_DTYPES} (impl=auto: K2, K3, K4 once each) + the wgmma "
        f"(bf16) and tf32x3 (f32) edge cases; every K3/K4 call by its "
        f"bwd_instance; worst per-row "
        f"rel err " + json.dumps({f"{a} {b}": v for (a, b), v in
                                  worst.items()})
        + "; the same rows each relative to its own max|plain| alone "
        f"(m, dq and dk rows not held to their largest term): "
        f"{json.dumps(own)}"
        + f"; tolerances {json.dumps({f'{a} {b}': v for (a, b), v in FLASH_TOL.items()})}")
    return worst


# The attention path at the repo's full width (bench.py's
# flash_attention_4096, benchmarks/flash_sweep.py): S tokens, H heads of D.
S_ATT, H_ATT, D_ATT = 4096, 8, 128
# peak rates for the bound (NVIDIA H100 SXM data sheet, dense): float32 on
# the CUDA cores, TF32 and bfloat16 on the tensor cores
PEAK_FLOPS = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12}


def peak_flops(name: str) -> float:
    """The rate behind the bound of a kernel of dtype ``name``: bf16 on the
    tensor cores; f32 the faster of the CUDA cores and three TF32
    tensor-core products per f32 product (3xTF32: 495 / 3 = 165 TFLOP/s),
    so an f32 bound is the lesser of FLOPs / 67 and 3·FLOPs / 495 TFLOP/s."""
    if name == "bfloat16":
        return PEAK_FLOPS["bfloat16"]
    return max(PEAK_FLOPS["float32"], PEAK_FLOPS["tf32"] / 3)
# serving against dense attention in f32, per row (_rel_err): in bf16 the
# kernel rounds P and the output (half an ulp, 2^-8 of an element, each)
SERVE_TOL = {"float32": 2e-5, "bfloat16": 2 ** -6}
# a training gradient sums dq/dk/dv (each within 5e-5 of plain in f32)
# over all S x H rows of the projections; in bf16 each grad is held to the
# per-row bar of the bf16 kernels (phases 6-7), 2^-6
TRAIN_GRAD_TOL = {"float32": 1e-4, "bfloat16": 2 ** -6}


def _by_instance(flash):
    return {"k2": flash.launches_fwd_by_instance,
            "k3": flash.launches_dq_by_instance,
            "k4": flash.launches_dkv_by_instance}


def _counts(k1, flash):
    n = dict(k1=k1.launches, k2=flash.launches_fwd, k3=flash.launches_dq,
             k4=flash.launches_dkv)
    n.update({f"k1_{inst}": c for inst, c in k1.launches_by_instance.items()})
    for key, by in _by_instance(flash).items():
        n.update({f"{key}_{inst}": c for inst, c in by.items()})
    return n


def _reset_counts(k1, flash):
    _reset_k1(k1)
    flash.launches_fwd = flash.launches_dq = flash.launches_dkv = 0
    for by in _by_instance(flash).values():
        for inst in by:
            by[inst] = 0


# the instance of each kernel that takes all-bf16 or all-f32 operands at
# D = D_ATT (<= 256)
HEADLINE_INSTANCE = {"bfloat16": {"k2": "wgmma", "k3": "wgmma",
                                  "k4": "wgmma"},
                     "float32": {"k2": "simt", "k3": "tf32x3",
                                 "k4": "tf32x3"}}


def _check_instance(n, name, what, kernels=("k2",)):
    """A call at the headline width launches each kernel by the instance
    HEADLINE_INSTANCE names for its dtype, and by no other."""
    for key in kernels:
        want = HEADLINE_INSTANCE[name][key]
        others = [k for k in n if k.startswith(f"{key}_")
                  and k != f"{key}_{want}"]
        if n[f"{key}_{want}"] <= 0 or any(n[k] for k in others):
            raise AssertionError(f"{what} {name}: {key.upper()} launches by "
                                 f"instance {n}")


def phase_serving(torch, pat, models, k1, flash):
    """Ulysses (non-causal) and causal ring attention over NCCL on a (1,)
    topology at full width, f32 and bf16, each against dense_attention on
    the card; the launches of each call, counted from 0 just before it."""
    topo = pat.Topology((1,))
    pen = pat.Pencil(topo, (S_ATT, H_ATT), (0,))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    out, recorded = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        q, k, v = (pat.PencilArray(pen, torch.randn(
            (S_ATT, H_ATT, D_ATT), generator=gen, device="cuda").to(dtype))
            for _ in range(3))
        for scheme, causal, fn in (
                ("ulysses", False, models.ulysses_attention),
                ("ring", True, models.ring_attention)):
            ref = models.dense_attention(q.data.float(), k.data.float(),
                                         v.data.float(), causal=causal)
            fn(q, k, v, causal=causal)          # warm-up
            torch.cuda.synchronize()
            _reset_counts(k1, flash)
            k1.recorded = {}
            t0 = time.perf_counter()
            got = fn(q, k, v, causal=causal)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            n = _counts(k1, flash)
            recorded[f"serve_{scheme}_{name}"], k1.recorded = k1.recorded, None
            err = _rel_err(torch, got.data, ref)
            if got.data.shape != q.data.shape or got.dtype != dtype:
                raise AssertionError(f"{scheme} output {got.data.shape}")
            if not bool(torch.isfinite(got.data.float()).all()):
                raise AssertionError(f"{scheme} {name}: non-finite output")
            if not err <= SERVE_TOL[name]:
                raise AssertionError(f"{scheme} {name}: rel err {err} "
                                     f"against dense > {SERVE_TOL[name]}")
            if n["k2"] <= 0 or (scheme == "ulysses" and n["k1"] <= 0):
                raise AssertionError(f"{scheme} {name} launched {n}")
            _check_instance(n, name, scheme)
            log(f"[serve] {scheme} {'causal' if causal else 'full'} S={S_ATT} "
                f"H={H_ATT} D={D_ATT} {name} (1,) NCCL: {ms:.3f} ms per call, "
                f"rel err vs dense {err:.3e} (<= {SERVE_TOL[name]}), "
                f"launches K1 {n['k1']} K2 {n['k2']} (wgmma "
                f"{n['k2_wgmma']}, simt {n['k2_simt']})")
            out[f"serve_{scheme}_{name}"] = dict(n, ms=ms)
            del ref, got
    torch.cuda.empty_cache()
    return out, recorded


def phase_training(torch, pat, models, k1, flash, dtype, steps=3):
    """The block of ``pencilarrays_tpu_torch/examples/
    long_context_training.py`` (the JAX package's
    ``examples/long_context_training.py``), trained through that module
    at full width: replicated D x D projections wq, wk, wv, wo, causal
    ring attention with zigzag=True (on a (1,) topology ring_attention
    runs the naive schedule: the zigzag one is checked in phase 6), MSE
    loss, SGD (the example's ``LR``).  The weights are f32 masters; in
    bf16, x and the weights are cast to bf16 for the projections, so
    q/k/v, the attention and its output are bf16, and the loss is taken
    in f32.
    One step's gradients on the kernel path against the plain path,
    then ``steps`` steps with every count reset just before."""
    from pencilarrays_tpu_torch.examples import long_context_training as lct

    S, H, D = S_ATT, H_ATT, D_ATT
    name = str(dtype).split(".")[-1]
    topo = pat.Topology((1,))
    pen = pat.Pencil(topo, (S, H), (0,))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    x = models.to_zigzag(pat.PencilArray(pen, rnd(S, H, D))).data
    target = models.to_zigzag(pat.PencilArray(pen, rnd(S, H, D))).data
    params = {w: rnd(D, D, scale=D ** -0.5).requires_grad_()
              for w in lct.WEIGHTS}

    def loss_and_grads(impl):
        return lct.loss_and_grads(params, x, target, pen, dtype, impl)

    _, g_kernel = loss_and_grads("kernel")
    _, g_plain = loss_and_grads("plain")
    grad_err = max(_rel_err(torch, g_kernel[w], g_plain[w]) for w in params)
    if not grad_err <= TRAIN_GRAD_TOL[name]:
        raise AssertionError(f"training {name} grads kernel vs plain: "
                             f"{grad_err}")
    log(f"[train] {name}: one step's grads, kernel path vs plain path on the "
        f"card: rel err {grad_err:.3e} (<= {TRAIN_GRAD_TOL[name]})")

    def step():
        loss, grads = loss_and_grads("auto")
        lct.sgd(params, grads, lct.LR[name])
        return loss

    torch.cuda.synchronize()
    _reset_counts(k1, flash)
    losses, step_ms = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(step())   # float(loss) synchronizes
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    n = _counts(k1, flash)
    log(f"[train] S={S} H={H} D={D} {name} causal ring (naive schedule on "
        f"one rank) on (1,): losses {losses}, step ms "
        f"{[round(t, 3) for t in step_ms]}, launches {n}")
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"training {name} loss did not fall: {losses}")
    # after the counts were read: where one step's time goes
    prof = profile(torch, step, f"training step S={S} H={H} D={D} {name}")
    if min(n["k2"], n["k3"], n["k4"]) <= 0:
        raise AssertionError(f"training {name} launched {n}")
    _check_instance(n, name, "training", ("k2", "k3", "k4"))
    return dict(losses=losses, step_ms=step_ms, launches=n,
                grad_err=grad_err, profile=prof)


# the head dim of phase 9's timings of the simt instances (D > 256 only)
SIMT_D = 512


def phase_flash_timing(torch, flash, bw, D=D_ATT, causals=(False, True)):
    """K2, K3 and K4 at S = S_ATT, H = H_ATT and head dim ``D``, f32 and
    bf16, for each of ``causals``: kernel ms (each by the instance its
    dtype and ``D`` pick: the headline instances at D_ATT, ``simt`` above
    256), plain ms, SDPA ms (a yardstick the port never calls) with the
    CUDA kernels SDPA launches, bound ms and the error against the plain
    version (rows of dq and dk held to their largest term where it is
    above their own max|plain|, as flash_compare holds them)."""
    import torch.nn.functional as F

    S, H = S_ATT, H_ATT
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        peak = peak_flops(name)
        for causal in causals:
            q, k, v, do = (torch.randn((S, H, 1, D), generator=gen,
                                       device="cuda").to(dtype)
                           for _ in range(4))
            kw = dict(causal=causal, q_offset=0, kv_offset=0)
            out, (m, l) = flash.flash_attention_fwd(q, k, v,
                                                    return_stats=True, **kw)
            out_p = flash.flash_attention_fwd_plain(q, k, v, **kw)
            L, Dr = flash.residuals(out, do, m, l)
            qf, kf, vf, dof = (x.reshape(S, H, D) for x in (q, k, v, do))
            dq = torch.empty_like(qf)
            dk, dv = torch.empty_like(kf), torch.empty_like(vf)
            grads_p = [g.reshape(S, H, D) for g in
                       flash.flash_attention_bwd_plain(q, k, v, out, do, m, l,
                                                       **kw)]
            tq, tk = _bwd_terms(torch, flash, q, k, v, do, L, Dr, **kw)
            it = 5
            timed = [(key, "simt" if D > 256
                      else HEADLINE_INSTANCE[name][key])
                     for key in ("k2", "k3", "k4")]
            launch = {
                "k2": lambda: flash.flash_attention_fwd(q, k, v, **kw),
                "k3": lambda: flash.launch_dq(qf, kf, vf, dof, L, Dr, dq,
                                              **kw),
                "k4": lambda: flash.launch_dkv(qf, kf, vf, dof, L, Dr, dk,
                                               dv, **kw)}
            pairs = {"k2": [(out, out_p, None)],
                     "k3": [(dq, grads_p[0], tq)],
                     "k4": [(dk, grads_p[1], tk), (dv, grads_p[2], None)]}
            got = {}
            for key, inst in timed:
                launch[key]()
                err = max(max_abs_err(torch, a, b) for a, b, _ in pairs[key])
                rel = max(_rel_err(torch, a, b, terms=t)
                          for a, b, t in pairs[key])
                tol = FLASH_TOL[("fwd" if key == "k2" else "bwd", name)]
                if not rel <= tol:
                    raise AssertionError(f"{key} {inst} {name} causal="
                                         f"{causal} at the headline shape: "
                                         f"rel err {rel} > {tol}")
                by0 = dict(_by_instance(flash)[key])
                ms = cuda_ms(torch, launch[key], it)
                by = {i: c - by0[i] for i, c in _by_instance(flash)[key].items()}
                if by != {i: (it + 1) * (i == inst) for i in by}:
                    raise AssertionError(f"{key} {name} timing of {inst} "
                                         f"launched {by}")
                got[key] = dict(ms=ms, max_abs_err=err, rel_err=rel,
                                timed_launches_by_instance=by)
            plain_fwd = cuda_ms(torch, lambda: flash.flash_attention_fwd_plain(
                q, k, v, **kw), it)
            plain_bwd = cuda_ms(torch, lambda: flash.flash_attention_bwd_plain(
                q, k, v, out, do, m, l, **kw), it)
            qt, kt, vt, gt = (x.reshape(S, H, D).transpose(0, 1)[None]
                              .contiguous() for x in (q, k, v, do))

            def sdpa_fwd():
                F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)

            qg, kg, vg = (x.clone().requires_grad_() for x in (qt, kt, vt))

            def sdpa_fwd_bwd():
                o = F.scaled_dot_product_attention(qg, kg, vg,
                                                   is_causal=causal)
                torch.autograd.grad(o, (qg, kg, vg), gt)

            lib_fwd = cuda_ms(torch, sdpa_fwd, it)
            lib_fb = cuda_ms(torch, sdpa_fwd_bwd, it)
            # the CUDA kernels SDPA launches (names cut to 120
            # characters), from two calls in one profile: a profile of
            # one f32 forward call has recorded no kernel
            fwd_kernels = [n[:120] for _, _, n in _kernel_rows(
                torch, lambda: (sdpa_fwd(), sdpa_fwd()))[1]]
            bwd_kernels = [n[:120] for _, _, n in _kernel_rows(
                torch, lambda: (sdpa_fwd_bwd(), sdpa_fwd_bwd()))[1]
                if n[:120] not in fwd_kernels]
            # FLOPs: 4 S^2 H D forward (QK^T, PV); K3 recomputes QK^T and
            # dO V^T and forms dS K (6); K4 adds P^T dO and dS^T Q to the
            # recompute (8); causal halves each
            f = 0.5 if causal else 1.0
            flops = {key: c * S * S * H * D * f
                     for key, c in (("k2", 4), ("k3", 6), ("k4", 8))}
            isz = q.element_size()
            nbytes = {"k2": 4 * S * H * D * isz,
                      "k3": (5 * S * H * D) * isz + 2 * S * H * 4,
                      "k4": (6 * S * H * D) * isz + 2 * S * H * 4}
            for key, inst in timed:
                t = got[key]
                bound = max(flops[key] / peak, nbytes[key] / bw) * 1e3
                r = dict(kernel=key, dtype=name, causal=causal,
                         head_dim=D, instance=inst, ms=t["ms"],
                         plain_ms=plain_fwd if key == "k2" else plain_bwd,
                         library_ms=None if lib_fwd is None
                         else lib_fwd if key == "k2" else lib_fb - lib_fwd,
                         library_kernels=fwd_kernels if key == "k2"
                         else bwd_kernels,
                         bound_ms=bound, bound_by="operations"
                         if flops[key] / peak >= nbytes[key] / bw
                         else "bytes",
                         tflops=flops[key] / t["ms"] / 1e9,
                         max_abs_err=t["max_abs_err"], rel_err=t["rel_err"],
                         timed_launches_by_instance=t[
                             "timed_launches_by_instance"])
                rows.append(r)
                log(f"[time] {key} {inst} S={S} H={H} D={D} {name} "
                    f"{'causal' if causal else 'full'}: " + json.dumps(r))
            ms = {key: got[key]["ms"] for key in ("k2", "k3", "k4")}
            log(f"[time] SDPA S={S} H={H} D={D} {name} "
                f"{'causal' if causal else 'full'}: fwd {lib_fwd} ms, "
                f"fwd+bwd {lib_fb} ms, kernels fwd {fwd_kernels} bwd "
                f"{bwd_kernels}; port fwd+bwd "
                f"{ms['k2'] + ms['k3'] + ms['k4']:.4f} ms (K2+K3+K4); plain fwd+bwd {plain_fwd + plain_bwd:.4f} ms")
            del q, k, v, do, qt, kt, vt, gt, qg, kg, vg
            torch.cuda.empty_cache()
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device available "
            "(torch.cuda.is_available() is false)")
        return 1
    import torch.distributed as dist

    import pencilarrays_tpu_torch as pat
    from pencilarrays_tpu_torch import models
    from pencilarrays_tpu_torch.ops import _build as build
    from pencilarrays_tpu_torch.ops import flash
    from pencilarrays_tpu_torch.ops import permute as k1
    from pencilarrays_tpu_torch.parallel import transpositions as tr

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # a run that hangs (a thread stuck in a wait, a kernel that never
    # ends) prints every thread's stack and exits within the time limit
    faulthandler.dump_traceback_later(WATCHDOG_S, exit=True, file=sys.stdout)
    t_start = time.perf_counter()
    marks = [("start", t_start)]

    def mark(phase):
        # each phase's wall seconds, printed after [done]
        marks.append((phase, time.perf_counter()))

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as dist_dir:
        try:
            smi, instances = phase_environment(torch, pat, build, dist_dir)
            bw = bandwidth(smi)
            mark("1")
            log(f"[env] bound uses {bw / 1e12:.2f} TB/s for '{smi}'")
            # phase 5f first: its rank processes share the card, and later
            # phases leave this process holding device memory that two
            # 512^3 ranks need
            clu = phase_cluster(torch, k1)
            mark("5f")
            psvc = phase_plan_service(torch, pat, k1, bw)
            mark("5g")
            flt = phase_fleet(torch, k1)
            mark("5h")
            phase_kernel(torch, k1)
            mark("2")
            cycle = phase_cycle(torch, pat, k1, tr)
            mark("3")
            wired = phase_wire(torch, pat, k1, tr, cycle)
            mark("3w")
            fft = phase_fft(torch, dist, pat, k1, tr)
            mark("4")
            ns = phase_navier_stokes(torch, dist, pat, k1, models)
            mark("5")
            grid = phase_grid_toolbox(torch, dist, pat, models, k1, tr, bw)
            mark("5b")
            io_res = phase_io(torch, pat, models, k1)
            mark("5c")
            eng = phase_engine(torch, pat, models, k1, tr, cycle, ns)
            mark("5d")
            grd = phase_guard(torch, pat, models, k1, cycle)
            mark("5e")
            release_groups(torch, "autodiff")
            ad = phase_autodiff(torch, pat, models, k1)
            mark("5i")
            # phase 5j as a user runs the examples on one card: in one
            # process without a process group (no one-rank NCCL
            # communicators to build and destroy); the world is made again
            # after it
            release_groups(torch, "examples")
            pat.distributed.finalize()
            ex = phase_examples(torch, pat, k1, flash)
            pat.distributed.initialize(
                "nccl", init_method=f"file://{os.path.join(dist_dir, 'rdv2')}",
                world_size=1, rank=0)
            mark("5j")
            checks = phase_flash_check(torch, flash, models.attention)
            mark("6")
            serve, serve_rec = phase_serving(torch, pat, models, k1, flash)
            mark("7")
            train = {f"train_{str(dt).split('.')[-1]}": phase_training(
                torch, pat, models, k1, flash, dt)
                for dt in (torch.float32, torch.bfloat16)}
            mark("8")
            timing = phase_flash_timing(torch, flash, bw)
            # the simt instances at a head dim they serve
            simt = phase_flash_timing(torch, flash, bw, D=SIMT_D,
                                      causals=(False,))
            mark("9")
            # phase 2's timings: every class phases 3-5c and 7 launched
            k1_runs = {**cycle, **wired["cycles"], **wired["reshard"],
                       "fused_hop": fft["fused_hop"],
                       "dct": fft["dct"],
                       "spectral_ops": grid["spectral_ops"],
                       "many_pencil_array": grid["many"], "io": io_res,
                       **eng["paths"], **grd["paths"], **ad["paths"]}
            recorded = {**{run: r["recorded"] for run, r in k1_runs.items()},
                        "navier_stokes": ns["recorded"], **serve_rec,
                        "cluster": clu["recorded"],
                        "plan_service": psvc["recorded"],
                        "fleet": flt["recorded"], **ex["recorded"]}
            release_groups(torch, "k1")
            k1_timed = k1_timing(torch, k1, bw, recorded, HOPS)
            mark("2t")
        finally:
            pat.distributed.finalize()
    per = {run: _k1_per_run(k1_timed, rec) for run, rec in recorded.items()
           if rec}
    per["navier_stokes_rk2_step"] = _k1_per_run(k1_timed, ns["recorded"],
                                                ns["steps"])
    for run, r in {**cycle, **wired["cycles"]}.items():
        per[run].update(cycle_ms=r["ms"], k1_bytes=r["k1_bytes"],
                        exchange_calls=r["exchange_calls"])
    for run, r in wired["reshard"].items():
        per[run].update(reshard_ms=r["ms"], verdict=r["verdict"],
                        peak_above_input=r["peak_above_input"],
                        peak_hbm_bytes=r["peak_hbm_bytes"])
    for run, v in per.items():
        if run.startswith("serve_"):
            v["serve_call_ms"] = serve[run]["ms"]
    log("[k1] per run (kernel, call, plain, library and bound ms of the K1 "
        "launches each made): " + json.dumps(per))
    main_case = k1_timed[("permute",) + MAIN_PATH[0][1:3] + (
        MAIN_PATH[0][3],)]
    # launches per path, each counted from 0 just before its run; the
    # kernels line gives their sum and each
    runs = {**{run: {k: c for k, c in n.items() if k != "ms"}
               for run, n in serve.items()},
            **{run: t["launches"] for run, t in train.items()},
            **{run: {k: c for k, c in n.items() if k != "seconds"}
               for run, n in ex["paths"].items()}}
    paths = {"k1": {"navier_stokes": ns["k1_launches"],
                    **{run: r["launches"] for run, r in k1_runs.items()}}}
    for inst, c in ns["k1_launches_by_instance"].items():
        paths.setdefault(f"k1_{inst}", {})["navier_stokes"] = c
    # phases 5f, 5g and 5h: their processes, each counting from 0 at its start
    for run, a in {**clu["paths"], **psvc["paths"],
                   **flt["paths"]}.items():
        paths["k1"][run] = a["launches"]
        for inst, c in a["launches_by_instance"].items():
            paths.setdefault(f"k1_{inst}", {})[run] = c
    for run, r in k1_runs.items():
        for inst, c in r["launches_by_instance"].items():
            paths.setdefault(f"k1_{inst}", {})[run] = c
    for run, n in runs.items():
        for key, count in n.items():
            paths.setdefault(key, {})
            if count:
                paths[key][run] = count
    kernels = [{
        "name": "permute",
        "route": "cuda",
        "source": "pencilarrays_tpu_torch/ops/csrc/permute.cu",
        "replaces": "pencilarrays_tpu/ops/pallas_kernels.py:98",
        "instance": main_case["instance"],
        "launches": sum(paths["k1"].values()),
        "launches_by_path": paths["k1"],
        "launches_by_instance": {
            i: sum(paths.get(f"k1_{i}", {}).values()) for i in k1.INSTANCES},
        "max_abs_err": max(r["max_abs_err"] for r in k1_timed.values()),
        "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": "bytes",
        "library_ms": main_case["library_ms"],
        "checked": True,
        "shape": MAIN_CASE,
        "per_run": per,
        "timings": [{k: v for k, v in r.items() if k != "bytes"}
                    for r in k1_timed.values()],
    }]
    # K2-K4: times at S=4096 H=8 D=128 f32 full by the instance f32 picks;
    # also per dtype (each by its instance)
    for key, name, src, replaces, insts in (
            ("k2", "flash_fwd", "flash_fwd.cu",
             "pencilarrays_tpu/ops/flash_pallas.py:287", ("wgmma", "simt")),
            ("k3", "flash_bwd_dq", "flash_bwd_tf32.cu",
             "pencilarrays_tpu/ops/flash_pallas.py:589",
             ("wgmma", "tf32x3", "simt")),
            ("k4", "flash_bwd_dkv", "flash_bwd_tf32.cu",
             "pencilarrays_tpu/ops/flash_pallas.py:609",
             ("wgmma", "tf32x3", "simt"))):
        mine = [r for r in timing if r["kernel"] == key]
        head = next(r for r in mine
                    if r["dtype"] == "float32" and not r["causal"])
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"pencilarrays_tpu_torch/ops/csrc/{src}",
            "instance": head["instance"],
            "sources": {i: "pencilarrays_tpu_torch/ops/csrc/" + (
                "flash_bwd_tf32.cu" if i == "tf32x3" else
                "flash_fwd.cu" if key == "k2" else "flash_bwd.cu")
                for i in insts},
            "replaces": replaces, "launches": sum(paths[key].values()),
            "launches_by_path": paths[key],
            "max_abs_err": head["max_abs_err"], "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "checked": True,
            "shape": f"S={S_ATT} H={H_ATT} D={D_ATT} float32 non-causal",
            "check_rel_err": {f"{a} {b}": v for (a, b), v in checks.items()
                              if (a == "fwd") == (key == "k2")},
            "timings": [{k: r[k] for k in ("dtype", "causal", "instance",
                                           "ms", "plain_ms",
                                           "library_ms", "bound_ms",
                                           "tflops", "max_abs_err",
                                           "rel_err")}
                        for r in mine],
            "library_kernels": {r["dtype"]: r["library_kernels"]
                                for r in mine if not r["causal"]},
            "launches_by_instance": {
                i: sum(paths[f"{key}_{i}"].values()) for i in insts},
            "by_dtype": {r["dtype"]: {k: r[k] for k in (
                "instance", "ms", "bound_ms", "bound_by", "plain_ms",
                "library_ms", "tflops", "max_abs_err", "rel_err",
                "timed_launches_by_instance")}
                for r in mine if not r["causal"]},
            "instances": instances[key],
            # simt at D = SIMT_D (> 256, the only calls it takes): 0
            # launches on every path
            f"simt_d{SIMT_D}": [{k: r[k] for k in (
                "dtype", "instance", "ms", "plain_ms", "library_ms",
                "library_kernels", "bound_ms", "bound_by", "tflops",
                "max_abs_err", "rel_err")}
                for r in simt if r["kernel"] == key]})
    faulthandler.cancel_dump_traceback_later()
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log("[phases] wall s by phase (2t: phase 2's timings): " + json.dumps(
        {b[0]: round(b[1] - a[1], 1) for a, b in zip(marks, marks[1:])}))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except BaseException:
        # the reason on stdout too, for readers of stdout alone; the
        # exception then propagates and the exit code is non-zero
        traceback.print_exc(file=sys.stdout)
        sys.stdout.flush()
        raise
    sys.exit(rc)
