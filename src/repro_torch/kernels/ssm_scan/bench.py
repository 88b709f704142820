"""Time the chunked SSD scan (K3) on the card at zamba2-7b's prefill shape,
against its two bounds, its plain version and other builds of the kernel;
with ``--wide``, its wide route at xlstm-350m's.

    PYTHONPATH=src python3 -m repro_torch.kernels.ssm_scan.bench [DIR ...]
    PYTHONPATH=src python3 -m repro_torch.kernels.ssm_scan.bench --wide [DIR ...]

Each DIR holds an edited copy of this kernel's ``csrc/`` directory (a
variant, named by DIR, or by its parent when DIR is called ``csrc``; for
example under ``build/dev/``, which ``.gitignore`` lists). A build that
exports ``ssd_chunked_launch`` runs in the mixer's form (strided (B, H,
S, ·) views of xdt and loga, B and C once per batch); one that exports
only ``ssd_scan_launch`` (the first version, one CTA per row) runs in the
3-D form on xdt transposed and B and C broadcast to every head, the
copies the mixer made for it, which are made once and not timed. The
port also runs in that 3-D form. Every build is checked against the plain
version at that shape with the mixer's decay (3e-3: the port must hold,
a variant that does not is reported and timed), three times, a mixer-form
build with its chunk-state scratch NaN-filled each time (a chunk that reads
its predecessor's state before it is written reads NaN, not what an
earlier call left in reused memory), then all are timed in
turns (every build, then every build again in reverse order), so that
versions are compared within one run on one card, and each build's
kernels are timed apart under the profiler. Prints each build's
ptxas report, the card's name and power limit and one line per build.

With ``--wide`` each DIR holds an edited copy of ``csrc/`` with its
``ssd_wide.cu``, and every build of the wide route runs the mLSTM's scan
(``WIDE_SHAPE``, inputs at the mLSTM's scale, in the mixer's layout), is
checked three times against the plain version with its chunk-state
scratch NaN-filled, and is timed in turns beside its bound (the TF32
peak), the 3xTF32 floor (three TF32 products for each, the way the
route's products run) and its operations' time at the float32 FMA peak,
each of its kernels timed apart under the profiler. The route's first
version (float32 FMA, four launches) is one such build:

    mkdir -p build/dev/pr18/csrc && git show \
        03c8dfb:src/repro_torch/kernels/ssm_scan/csrc/ssd_wide.cu \
        > build/dev/pr18/csrc/ssd_wide.cu

Needs a CUDA device.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

TOL = 3e-3
H100_BYTES_PER_S = 3.35e12
H100_TF32_FLOPS = 495e12        # dense TF32 tensor cores, SXM, 700 W
H100_F32_FLOPS = 67e12          # float32 FMA outside the tensor cores, SXM, 700 W
# zamba2-7b's prefill wave: 4 prompts padded to 1,819 tokens, 112 heads of
# 64, state 64, one group, chunk 128.
SHAPE = dict(bsz=4, h=112, g=1, s=1819, p=64, n=64, chunk=128)
# xlstm-350m's prefill wave: 4 prompts padded to 1,819 tokens, 4 heads
# with a 512 x 513 matrix memory each (G = H), chunk 512.
WIDE_SHAPE = dict(bsz=4, h=4, s=1819, p=513, n=512, chunk=512)


def scan_work(bsz, h, g, s, p, n, chunk) -> tuple:
    """The bytes and operations the scan must take, float32: xdt and loga
    read and y and the final state written once per head, B and C read
    once per group; the products per chunk of L valid steps (C B^T over
    the L(L+1)/2 lower-triangle pairs once per group; per head the
    intra-chunk product over those pairs and the state update over L·N·P,
    and after the first chunk the inter-chunk product over L·N·P). G = H is
    the same function fed B and C broadcast to every head. Returns (bytes,
    flops)."""
    nbytes = 4 * (bsz * h * (2 * s * p + s + n * p) + 2 * bsz * g * s * n)
    q = min(chunk, s)
    per_head = per_group = 0
    for t0 in range(0, s, q):
        steps = min(q, s - t0)
        tri = steps * (steps + 1) // 2
        per_group += 2 * tri * n
        per_head += 2 * tri * p + (4 if t0 else 2) * steps * n * p
    return nbytes, bsz * h * per_head + bsz * g * per_group


def bound_ms(bsz, h, g, s, p, n, chunk) -> tuple:
    """Least time for the scan on an H100: ``scan_work``'s bytes over the
    memory rate against its operations over the TF32 tensor-core peak, the
    card's peak for float32 operands (both routes: the first runs 3xTF32
    products, the wide one float32 FMA, but the function is the same).
    Returns (ms, "bytes" | "operations")."""
    nbytes, flops = scan_work(bsz, h, g, s, p, n, chunk)
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_TF32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _time_ms(torch, fn, reps: int = 20) -> float:
    """Median milliseconds of ``fn`` by CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


def heads_inputs(torch, bsz, h, g, s, p, n, seed, device="cuda"):
    """The mixer's layout: xdt (B, S, H, P) and loga (B, S, H), returned as
    (B, H, S, ·) views, and b, c (B, G, S, N); xdt, b, c ~ N(0, 1), loga =
    -softplus(N(0, 1)) as the mixer draws it at init (~-0.8 a step, so
    that exp(cum_i - cum_j) above a 128-step chunk's diagonal overflows)."""
    gen = torch.Generator().manual_seed(seed)
    xdt = torch.randn(bsz, s, h, p, generator=gen)
    loga = -torch.nn.functional.softplus(torch.randn(bsz, s, h, generator=gen))
    b, c = (torch.randn(bsz, g, s, n, generator=gen) for _ in range(2))
    xdt, loga, b, c = (t.to(device) for t in (xdt, loga, b, c))
    return xdt.transpose(1, 2), loga.transpose(1, 2), b, c


def mlstm_inputs(torch, bsz, h, s, p, n, seed, device="cuda"):
    """The mLSTM's scan inputs at the reference's init, in the mixer's
    layout: q ~ N(0, 1), k ~ N(0, 1) / sqrt(N), v ~ N(0, 1), i = sigmoid(N(0,
    1)), log f = log sigmoid(N(0, 1)) (~-0.8 a step, so that exp(cum) over a
    512-step chunk underflows to 0); xdt = [v ‖ 1] i (B, S, H, P + 1 = p) on
    rows padded to a multiple of 4 floats, as ``xlstm.values_ext`` builds it,
    loga (B, S, H), b = k and c = q (B, S, H, N), returned as (B, H, S, ·)
    views with G = H."""
    from repro_torch.kernels.ssm_scan import wide

    gen = torch.Generator().manual_seed(seed)
    rnd = lambda *shape: torch.randn(*shape, generator=gen)
    i_gate = torch.sigmoid(rnd(bsz, s, h))
    loga = torch.nn.functional.logsigmoid(rnd(bsz, s, h))
    v = torch.cat([rnd(bsz, s, h, p - 1), torch.ones(bsz, s, h, 1)], dim=-1)
    xdt = wide.empty_aligned((bsz, s, h, p), device)
    xdt.copy_(v * i_gate[..., None])
    b, c = rnd(bsz, s, h, n) / n ** 0.5, rnd(bsz, s, h, n)
    return (xdt.transpose(1, 2), *(t.to(device).transpose(1, 2) for t in (loga, b, c)))


def broadcast_3d(xdt, loga, b, c):
    """The (BH, S, ·) copies of the mixer's inputs that the first version read."""
    bsz, h, s, p = xdt.shape
    rep = lambda t: t.repeat_interleave(h // t.shape[1], dim=1).reshape(bsz * h, s, -1)
    return (xdt.reshape(bsz * h, s, p), loga.reshape(bsz * h, s), rep(b).contiguous(),
            rep(c).contiguous())


def _declare_any(lib: ctypes.CDLL) -> None:
    from repro_torch.kernels.ssm_scan import ops

    if hasattr(lib, "ssd_chunked_launch"):
        ops._declare(lib)
        return
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.ssd_scan_launch.argtypes = [ptr] * 6 + [i32] * 5 + [ptr]
    lib.ssd_scan_launch.restype = i32


def _legacy(torch, lib, args3, chunk):
    """One launch of a first-version build on the 3-D form."""
    xdt, loga, b, c = args3
    bh, s, p = xdt.shape
    n = b.shape[-1]
    y = torch.empty_like(xdt)
    st = torch.empty(bh, n, p, dtype=torch.float32, device=xdt.device)
    err = lib.ssd_scan_launch(xdt.data_ptr(), loga.data_ptr(), b.data_ptr(), c.data_ptr(),
                              y.data_ptr(), st.data_ptr(), bh, s, p, n, min(chunk, s),
                              torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"legacy ssd_scan_launch failed ({err})")
    return y, st


def _check(torch, name: str, run, want_y, want_s) -> None:
    """One run of a build against the plain version's y and final state;
    the port must hold, another build is reported either way."""
    y, st = run()
    y = y.reshape(want_y.shape)
    st = st.reshape(want_s.shape)
    torch.cuda.synchronize()
    err = max((y - want_y).abs().max().item(), (st - want_s).abs().max().item())
    finite = bool(torch.isfinite(y).all() and torch.isfinite(st).all())
    print(f"[check] {name}: max abs err {err:.3e} against the plain version, "
          f"finite {finite}", flush=True)
    if not (finite and torch.allclose(y, want_y, atol=TOL, rtol=TOL)
            and torch.allclose(st, want_s, atol=TOL, rtol=TOL)):
        if name == "port":
            raise AssertionError(f"the port differs from the plain version by {err:.3e}")
        print(f"[check] {name}: NOT within {TOL} (timed all the same)", flush=True)


def _ptxas_report(name: str, log: str) -> None:
    for line in log.splitlines():
        if "Compiling entry" in line:
            print(f"[ptxas {name}] {line.split('Compiling entry function')[-1].strip()[:60]}",
                  flush=True)
        elif any(w in line for w in ("registers", "spill", "error", "C75")):
            print(f"[ptxas {name}]   {line.strip()[:160]}", flush=True)


def main(argv: list[str]) -> int:
    import torch

    from repro_torch.kernels.build import CudaLibrary, build_all
    from repro_torch.kernels.ssm_scan import ops

    if not torch.cuda.is_available():
        print("ssm_scan.bench: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    if argv[:1] == ["--wide"]:
        return main_wide(torch, argv[1:])
    builds = {"port": ops.LIBRARY}
    for arg in argv:
        d = Path(arg)
        name = d.parent.name if d.name == "csrc" else d.name
        builds[name] = CudaLibrary(f"ssd_{name}", d / "ssd_scan.cu", _declare_any)
    build_all(builds.values())
    for name, lib in builds.items():
        _ptxas_report(name, lib.build_log)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)

    chunk = SHAPE["chunk"]
    dims = {k: v for k, v in SHAPE.items() if k != "chunk"}
    args = heads_inputs(torch, **dims, seed=8)
    args3 = broadcast_3d(*args)
    want_y, want_s = ops._plain(*args, chunk=chunk)
    port = ops.LIBRARY

    def with_lib(lib, fn):
        def run():
            ops.LIBRARY = lib
            return fn()
        return run

    runs = {}
    for name, lib in builds.items():
        if hasattr(lib.load(), "ssd_chunked_launch"):
            runs[name] = with_lib(lib, lambda: ops.ssd_scan_heads(*args, chunk=chunk))
        else:
            runs[name] = lambda lib=lib: _legacy(torch, lib.load(), args3, chunk)
    runs["port 3-D"] = with_lib(port, lambda: ops.ssd_chunked_scan(*args3, chunk=chunk))

    def nan_states():
        bsz, h, s, p = args[0].shape
        y = torch.empty(bsz, s, h, p, device="cuda").transpose(1, 2)
        states = torch.full((bsz, h, -(-s // chunk), args[2].shape[-1], p), float("nan"),
                            device="cuda")
        return ops._run(*args, chunk, y, states=states)

    checks = {name: with_lib(builds[name], nan_states) for name in builds
              if hasattr(builds[name].load(), "ssd_chunked_launch")}
    try:
        for name, run in runs.items():
            for _ in range(3):
                _check(torch, name, checks.get(name, run), want_y, want_s)
        del want_y, want_s
        times = {}
        for name in [*runs, *reversed(runs)]:
            times.setdefault(name, []).append(_time_ms(torch, runs[name]))
    finally:
        ops.LIBRARY = port
    plain_ms = _time_ms(torch, lambda: ops._plain(*args, chunk=chunk), 5)
    copies_ms = _time_ms(torch, lambda: broadcast_3d(*args))
    grouped, by = bound_ms(**SHAPE)
    bcast, by_b = bound_ms(**{**SHAPE, "g": SHAPE["h"]})
    print(f"[time] zamba2-7b prefill shape {SHAPE}, float32: bound {grouped:.6f} ms ({by}) "
          f"with B and C per batch, {bcast:.6f} ms ({by_b}) broadcast; plain {plain_ms:.4f} ms; "
          f"the broadcast copies {copies_ms:.4f} ms", flush=True)
    for name, t in times.items():
        print(f"[time] {name}: {t[0]:.4f} / {t[1]:.4f} ms, {min(t) / grouped:.2f}x the grouped "
              f"bound, {min(t) / bcast:.2f}x the broadcast bound", flush=True)
    for name, run in runs.items():
        _kernel_times(torch, name, run)
    ops.LIBRARY = port
    return 0


def main_wide(torch, argv: list[str]) -> int:
    """The wide route's builds in turns at ``WIDE_SHAPE``."""
    from repro_torch.kernels.build import CudaLibrary, build_all
    from repro_torch.kernels.ssm_scan import ops, wide

    builds = {"port": wide.LIBRARY}
    for arg in argv:
        d = Path(arg)
        name = d.parent.name if d.name == "csrc" else d.name
        builds[name] = CudaLibrary(f"ssd_wide_{name}", d / "ssd_wide.cu", wide._declare)
    build_all(builds.values())
    for name, lib in builds.items():
        _ptxas_report(name, lib.build_log)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    sh = WIDE_SHAPE
    args = mlstm_inputs(torch, sh["bsz"], sh["h"], sh["s"], sh["p"], sh["n"], seed=9)
    want_y, want_s = ops._plain(*args, chunk=sh["chunk"])
    port = wide.LIBRARY

    def with_lib(lib, fn):
        def run():
            wide.LIBRARY = lib
            return fn()
        return run

    def nan_states():
        bsz, h, s, p = args[0].shape
        y = torch.empty(bsz, s, h, p, device="cuda").transpose(1, 2)
        states = torch.full((bsz, h, -(-s // sh["chunk"]), sh["n"], p), float("nan"),
                            device="cuda")
        return ops._run(*args, sh["chunk"], y, states=states)

    runs = {name: with_lib(lib, lambda: ops.ssd_scan_heads(*args, chunk=sh["chunk"]))
            for name, lib in builds.items()}
    try:
        for name, lib in builds.items():
            for _ in range(3):
                _check(torch, name, with_lib(lib, nan_states), want_y, want_s)
        del want_y, want_s
        times = {}
        for name in [*runs, *reversed(runs)]:
            times.setdefault(name, []).append(_time_ms(torch, runs[name]))
        plain_ms = _time_ms(torch, lambda: ops._plain(*args, chunk=sh["chunk"]), 5)
        dims = (sh["bsz"], sh["h"], sh["h"], sh["s"], sh["p"], sh["n"], sh["chunk"])
        bound, by = bound_ms(*dims)
        flops = scan_work(*dims)[1]
        fma = flops / H100_F32_FLOPS * 1e3
        floor3 = 3 * flops / H100_TF32_FLOPS * 1e3
        print(f"[time] xlstm-350m prefill shape {sh}, float32: bound {bound:.6f} ms ({by}, "
              f"TF32 peak); 3xTF32 floor {floor3:.6f} ms (three TF32 products each); "
              f"{fma:.6f} ms for its operations at the float32 FMA peak; plain "
              f"{plain_ms:.4f} ms", flush=True)
        for name, t in times.items():
            print(f"[time] {name}: {t[0]:.4f} / {t[1]:.4f} ms, {min(t) / bound:.2f}x the "
                  f"bound, {min(t) / floor3:.2f}x the 3xTF32 floor, {min(t) / fma:.2f}x the "
                  "float32 FMA time", flush=True)
        for name, run in runs.items():
            _kernel_times(torch, name, run, pattern=r"wide_\w+")
    finally:
        wide.LIBRARY = port
    return 0


def kernel_times(torch, run, pattern: str, reps: int = 10) -> dict:
    """{kernel: (mean device ms per call of ``run``, launches per call)} of
    the kernels whose names match ``pattern``, from the profiler."""
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
    times = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0.0)
        found = re.search(pattern, e.key)
        if found and us:
            times[found.group(0)] = (us / reps / 1e3, e.count / reps)
    return times


def _kernel_times(torch, name: str, run, pattern: str = r"ssd_\w+") -> None:
    for kernel, (ms, count) in kernel_times(torch, run, pattern).items():
        print(f"[kernel] {name}: {kernel} {ms:.4f} ms x{count:.0f}", flush=True)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
