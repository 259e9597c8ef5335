"""Drive the PyTorch/CUDA port (turingassembler_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero
before printing a result:
  1. device: name, power limit (nvidia-smi), torch and CUDA versions
  2. build: compile every CUDA kernel of the port (nvcc, sm_90a)
  3. kernel vs plain: the NW alignment kernel against its plain PyTorch
     version on the card, exact equality: map, ragged and long-query
     shapes, every compiled strip width at and around its tile edge
     (both scorings and modes), and the bubble check's shapes; kernel
     and plain times, G cells/s and the bound at the map shape, kernel
     time at a bubble shape
  4. slice parity: a reduced error-laden workload through the port on
     the card and on the CPU; every output identical
  5. full width: bench.py's workload (2 Mbp genome, 1,048,576 reads of
     150 bp, k=45) through count -> level-0 build -> minimizer index ->
     DP-verified map, plus 66,560 reads with one mid-read indel; launch
     counts are reset just before and read just after; then one more
     pass under torch.profiler for the device's busy share
  6. the `kernels` JSON line, the nvidia-smi line, and last the result
     line {"ok": true, "device": {...}}

It needs one CUDA GPU; without one it exits non-zero and prints no
result.  Kernels build at first use into build/kernels/.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM published peaks (dense): memory 3.35 TB/s; no int32 ALU rate
# is published, so the float32 non-tensor rate (67 TFLOP/s) bounds the
# kernel's 32-bit integer operations from below.
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12


def log(*a):
    print(*a, flush=True)


def device_info():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU visible", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[0]
    log(f"device: {torch.cuda.get_device_name(0)}; torch {torch.__version__}"
        f"; CUDA {torch.version.cuda}; count {torch.cuda.device_count()}")
    log(f"nvidia-smi: {smi}")
    return smi


def cuda_ms(fn, reps: int) -> float:
    fn()                                   # warm-up
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def random_pairs(rng, B, Lq, Lt):
    """Random codes with some code-4 bases and 255 padding past random
    lengths (qlen = 0 and tlen = 0 included); half the pairs are a
    target slice with edits."""
    q = rng.integers(0, 5, (B, Lq)).astype(np.uint8)
    t = rng.integers(0, 5, (B, Lt)).astype(np.uint8)
    qlen = rng.integers(0, Lq + 1, B).astype(np.int32)
    tlen = rng.integers(0, Lt + 1, B).astype(np.int32)
    qlen[0], tlen[1] = 0, 0
    half = np.arange(0, B, 2)
    off = rng.integers(0, 17, len(half))
    src = np.minimum(off[:, None] + np.arange(Lq)[None, :], Lt - 1)
    q[half] = np.take_along_axis(t[half], src, axis=1)
    q[half, rng.integers(0, Lq, len(half))] = rng.integers(0, 4, len(half))
    q[np.arange(Lq)[None, :] >= qlen[:, None]] = 255
    t[np.arange(Lt)[None, :] >= tlen[:, None]] = 255
    return q, qlen, t, tlen


def map_shape_pairs(rng, B, read_len=150, Lq=152, pad=16):
    """The remainder DP's own shape: a 150 bp read with one deleted base
    at read position 50-99 against its target window, which has 16 bases
    of slack on each side (Lt = Lq + 32)."""
    from turingassembler_tpu_torch import testing as tt
    Lt = Lq + 2 * pad
    genome = tt.random_genome(1 << 20, seed=5)
    w0 = rng.integers(0, len(genome) - Lt, B)
    t = genome[w0[:, None] + np.arange(Lt)[None, :]]
    t[:, read_len + 2 * pad:] = 255
    p = rng.integers(50, 100, B)[:, None]
    j = np.arange(read_len)[None, :]
    q = np.full((B, Lq), 255, np.uint8)
    q[:, :read_len] = np.take_along_axis(t, pad + j + (j >= p), axis=1)
    return (q, np.full(B, read_len, np.int32), t,
            np.full(B, read_len + 2 * pad, np.int32))


def bubble_pairs(rng, B, L):
    """The bubble check's shape: two branches padded to a common power
    of two L.  Half the pairs are a copy with a few substitutions and
    one short deletion (a length difference); the rest are unrelated."""
    q = rng.integers(0, 4, (B, L)).astype(np.uint8)
    t = rng.integers(0, 4, (B, L)).astype(np.uint8)
    qlen = rng.integers(L // 2 + 1, L + 1, B).astype(np.int32)
    tlen = rng.integers(L // 2 + 1, L + 1, B).astype(np.int32)
    half = np.arange(0, B, 2)
    cut = rng.integers(1, 9, len(half))
    at = rng.integers(0, L // 2, len(half))
    j = np.arange(L)[None, :]
    src = np.minimum(j + (j >= at[:, None]) * cut[:, None], L - 1)
    t[half] = np.take_along_axis(q[half], src, axis=1)
    for _ in range(3):
        t[half, rng.integers(0, L // 2, len(half))] = rng.integers(
            0, 4, len(half))
    tlen[half] = qlen[half] - cut
    q[j >= qlen[:, None]] = 255
    t[j >= tlen[:, None]] = 255
    return q, qlen, t, tlen


def phase_kernel_vs_plain():
    from turingassembler_tpu_torch.ops import dp, nw_align
    from turingassembler_tpu_torch.ops.align import affine_global_score_batch
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    both = (("bwa", dp.SCORING_BWA), ("bubble", dp.SCORING_BUBBLE))
    max_err = 0

    def put(*arrs):
        return [torch.as_tensor(a).to(dev) for a in arrs]

    def hold(what, q, ql, t, tl, scorings=both, modes=("global", "fit"),
             strip=None):
        nonlocal max_err
        for name, sc in scorings:
            for mode in modes:
                got = nw_align.banded_affine_score(q, ql, t, tl, *sc,
                                                   mode=mode, _strip=strip)
                want = affine_global_score_batch(q, ql, t, tl, *sc,
                                                 mode=mode)
                torch.cuda.synchronize()
                err = int((got.long() - want.long()).abs().max())
                max_err = max(max_err, err)
                log(f"kernel vs plain {what} B={q.shape[0]} Lq={q.shape[1]} "
                    f"Lt={t.shape[1]} {name} {mode}: max |diff| {err}")
                if err:
                    raise AssertionError("NW kernel disagrees with plain")

    # the map shape; a ragged shape that crosses column tiles; a long
    # query; 8 pairs a block whose tile carries need the shared-memory
    # opt-in above 48 KB
    for (B, Lq, Lt) in ((65_536, 152, 184), (300, 37, 1_500),
                        (8, 3_500, 3_600), (2_112, 1_000, 600)):
        plan = nw_align.launch_plan(B, Lq, Lt)
        hold(f"(strip {plan[0]}, {plan[1]} pairs a block)",
             *put(*random_pairs(rng, B, Lq, Lt)))
    # every compiled strip width S: one column short of a full tile of
    # 32*S columns, the full tile, and one column into a second tile;
    # the narrowest width also over three tiles
    for S in nw_align.STRIPS:
        edges = (32 * S - 1, 32 * S, 32 * S + 1) + ((150,) if S == 2 else ())
        for Lt in edges:
            hold(f"strip {S}", *put(*random_pairs(rng, 512, 40, Lt)),
                 strip=S)
    # the bubble check: global mode, bubble scoring, many narrow pairs
    # and few wide ones
    bubble = both[1:]
    for (B, L) in ((4_096, 256), (32, 1_024)):
        hold("bubble shape", *put(*bubble_pairs(rng, B, L)), scorings=bubble,
             modes=("global",))

    def rate(ql, tl, ms):
        cells = int((ql.long() * (tl.long() + 1)).sum())
        return cells, cells / ms / 1e6

    # timing at the map's remainder-DP shape, BWA scoring, fit mode
    q, ql, t, tl = put(*map_shape_pairs(rng, 65_536))
    sc = dp.SCORING_BWA

    def kernel():
        return nw_align.banded_affine_score(q, ql, t, tl, *sc, mode="fit")

    def plain():
        return affine_global_score_batch(q, ql, t, tl, *sc, mode="fit")

    got, want = kernel(), plain()
    err = int((got.long() - want.long()).abs().max())
    max_err = max(max_err, err)
    if err:
        raise AssertionError("NW kernel disagrees with plain (map shape)")
    ms = cuda_ms(kernel, 20)
    plain_ms = cuda_ms(plain, 3)
    ms_again = cuda_ms(kernel, 20)
    cells, gcells = rate(ql, tl, min(ms, ms_again))
    nbytes = q.numel() + t.numel() + 4 * 3 * q.shape[0]  # qlen, tlen, out
    t_ops = nw_align.OPS_PER_CELL * cells / PEAK_OPS_S * 1e3
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    log(f"NW kernel at map shape B=65536 Lq=152 Lt=184 (fit, BWA): "
        f"{ms:.4f} ms then {ms_again:.4f} ms ({gcells:.1f} G cells/s); "
        f"plain {plain_ms:.4f} ms; "
        f"{cells} cells; bound {max(t_ops, t_bytes):.5f} ms "
        f"(ops {t_ops:.5f}, bytes {t_bytes:.6f})")

    # timing at the bubble check's shape, bubble scoring, global mode
    bq, bql, bt, btl = put(*bubble_pairs(rng, 4_096, 256))
    bms = cuda_ms(lambda: nw_align.banded_affine_score(
        bq, bql, bt, btl, *dp.SCORING_BUBBLE, mode="global"), 20)
    bcells, bg = rate(bql, btl, bms)
    log(f"NW kernel at bubble shape B=4096 Lq=256 Lt=256 (global, bubble): "
        f"{bms:.4f} ms ({bg:.1f} G cells/s); {bcells} cells; bound "
        f"{nw_align.OPS_PER_CELL * bcells / PEAK_OPS_S * 1e3:.5f} ms (ops)")
    return dict(max_abs_err=max_err, ms=min(ms, ms_again), plain_ms=plain_ms,
                bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def run_slice(reads, lengths, k, min_count, device):
    """count -> build -> index -> verified map on one device."""
    from turingassembler_tpu_torch.graph.device_build import \
        build_graph_on_device
    from turingassembler_tpu_torch.kmer.megasort import \
        count_kedges_megasort_device
    from turingassembler_tpu_torch.mapper.minimizers import (
        EdgeMinimizerIndex, map_reads)

    def batches():
        for i in range(0, len(reads), 4096):
            yield reads[i:i + 4096], lengths[i:i + 4096]

    u, c, n = count_kedges_megasort_device(batches(), k, min_count=min_count,
                                           device=device)
    g = build_graph_on_device(u, c, n, k, device=device)
    idx = EdgeMinimizerIndex.build(g, device=device)
    e, h, s = map_reads(idx, reads, lengths, graph=g, device=device)
    return dict(uniq=u.cpu().numpy(), counts=c.cpu().numpy(), graph=g,
                index=idx, edges=e, hits=h, starts=s)


def phase_slice_parity():
    from turingassembler_tpu_torch import testing as tt
    from turingassembler_tpu_torch.ops import nw_align
    genome = tt.random_genome(50_000, seed=11)
    reads, lengths = tt.sim_reads(genome, coverage=30, read_len=150,
                                  seed=12, error_rate=0.004, pad_to=152)
    ir, il = tt.sim_indel_reads(genome, 2_000, 150, seed=13, pad_to=152)
    reads = np.concatenate([reads, ir])
    lengths = np.concatenate([lengths, il])
    before = nw_align.COUNT.launches
    gpu = run_slice(reads, lengths, 45, 2, "cuda")
    torch.cuda.synchronize()
    launched = nw_align.COUNT.launches - before
    cpu = run_slice(reads, lengths, 45, 2, "cpu")
    for key in ("uniq", "counts", "edges", "hits", "starts"):
        if not np.array_equal(gpu[key], cpu[key]):
            raise AssertionError(f"slice parity: {key} differs")
    for f in ("edge_source", "edge_target", "edge_rc", "edge_count",
              "seq_off", "seq_data", "node_rc", "adj_off", "adj_list"):
        if not np.array_equal(getattr(gpu["graph"], f),
                              getattr(cpu["graph"], f)):
            raise AssertionError(f"slice parity: graph {f} differs")
    for f in ("keys", "edge", "pos", "count"):
        if not np.array_equal(getattr(gpu["index"], f),
                              getattr(cpu["index"], f)):
            raise AssertionError(f"slice parity: index {f} differs")
    if launched < 1:
        raise AssertionError("slice parity: the NW kernel never launched")
    mapped = (gpu["edges"] >= 0).mean()
    log(f"slice parity (50 kbp, {len(reads)} reads, k=45, min count 2): "
        f"card == CPU for the count table ({len(gpu['counts'])} k-edges), "
        f"graph (n_e {gpu['graph'].n_e}), index and map "
        f"({mapped * 100:.2f}% mapped); NW launches {launched}")


N_INDEL = 66_560   # 65,536 + 1,024: a few hundred indel reads near
                   # position 99 clear the gapless bound and skip the DP


def run_main_path(reads, lengths, ir, il, k, around=None):
    """count -> build -> index -> verified map of the reads (from the
    count's device tensors), then the verified map of the indel reads.
    Each stage ends in a device sync; `around(name)`, when given, is a
    context manager entered around each stage.  Returns stage seconds
    and the outputs."""
    import contextlib

    from turingassembler_tpu_torch.graph.device_build import \
        build_graph_on_device
    from turingassembler_tpu_torch.kmer.megasort import count_reads_device
    from turingassembler_tpu_torch.mapper.minimizers import (
        EdgeMinimizerIndex, map_reads)
    st, out = {}, {}

    def stage(name, fn):
        torch.cuda.synchronize()
        with around(name) if around else contextlib.nullcontext():
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            st[name] = time.perf_counter() - t0
        return res

    u, c, out["n"], shipped = stage("count", lambda: count_reads_device(
        reads, lengths, k, return_chunks=True))
    g = out["g"] = stage("build", lambda: build_graph_on_device(
        u, c, out["n"], k))
    idx = out["idx"] = stage("index", lambda: EdgeMinimizerIndex.build(g))
    out["e"], _, out["s"] = stage("map", lambda: map_reads(
        idx, reads, lengths, graph=g, shipped=shipped, with_hits=False))
    out["ei"], _, _ = stage("map_indel", lambda: map_reads(
        idx, ir, il, graph=g))
    return st, out


def profile_main_path(reads, lengths, ir, il, k):
    """One more pass with torch.profiler around each stage on its own:
    the device's busy time (sum of kernel and copy times) per stage, and
    the kernels that take it."""
    import contextlib

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    busy, kernels, host = {}, {}, {}

    @contextlib.contextmanager
    def around(name):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            yield
        busy[name] = 0.0
        cpu_ops = []
        for ev in prof.key_averages():
            if ev.device_type == DeviceType.CUDA and ev.self_device_time_total:
                busy[name] += ev.self_device_time_total / 1e6
                c = kernels.setdefault(ev.key, [0.0, 0])
                c[0] += ev.self_device_time_total / 1e3
                c[1] += ev.count
            elif ev.self_cpu_time_total:
                cpu_ops.append((ev.self_cpu_time_total / 1e3, ev.key))
        host[name] = sorted(cpu_ops, reverse=True)[:3]

    st, _ = run_main_path(reads, lengths, ir, il, k, around)
    wall, dev = sum(st.values()), sum(busy.values())
    if dev == 0:
        log("profile: the profiler saw no device time (not measured)")
        return
    log(f"profile (one more full-width pass, profiler on): stages wall "
        f"{wall:.3f} s, device busy {dev:.3f} s ({dev / wall * 100:.1f}%)")
    for name, sec in st.items():
        log(f"profile:   stage {name:9s} wall {sec:.3f} s, device busy "
            f"{busy[name]:.3f} s ({busy[name] / sec * 100:.1f}%); top host "
            "ops (self ms): " + ", ".join(f"{k_} {ms:.1f}"
                                          for ms, k_ in host[name]))
    for key, (ms, cnt) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]:
        log(f"profile:   {ms:10.3f} ms  x{cnt:<6d} {key[:100]}")


def phase_full_width():
    from turingassembler_tpu_torch import testing as tt
    from turingassembler_tpu_torch.ops import nw_align

    k, read_len, n_reads, G = 45, 150, 1_048_576, 2_000_000
    genome = tt.random_genome(G, seed=0)
    reads, lengths = tt.sim_reads(genome, coverage=n_reads * read_len / G,
                                  read_len=read_len, seed=1,
                                  pad_to=read_len + 2)
    reads, lengths = reads[:n_reads], lengths[:n_reads]
    ir, il = tt.sim_indel_reads(genome, N_INDEL, read_len, seed=2,
                                pad_to=read_len + 2)

    torch.cuda.reset_peak_memory_stats()
    nw_align.COUNT.reset()
    st, out = run_main_path(reads, lengths, ir, il, k)
    launches, pairs = nw_align.COUNT.launches, nw_align.COUNT.pairs
    g, idx, e, s, ei = out["g"], out["idx"], out["e"], out["s"], out["ei"]

    passes = [st] + [run_main_path(reads, lengths, ir, il, k)[0]
                     for _ in range(2)]
    for i, p in enumerate(passes):
        log(f"full width pass {i} stage seconds: " + ", ".join(
            f"{k_} {v:.4f}" for k_, v in p.items()))
    st = {k_: float(np.median([p[k_] for p in passes])) for k_ in st}
    mapped, acc_indel = float((e >= 0).mean()), float((ei >= 0).mean())
    log(f"full width: n_unique {out['n']}, n_v {g.n_v}, n_e {g.n_e}, "
        f"{len(idx.keys)} minimizer keys; mapped {mapped * 100:.3f}% of "
        f"{n_reads} error-free reads, {acc_indel * 100:.3f}% of {N_INDEL} "
        f"indel reads; remainder DP pairs {pairs} in {launches} NW launches"
        f"; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log("full width: count+build+map "
        f"{n_reads / (st['count'] + st['build'] + st['map']):.1f} reads/s "
        f"(median of {len(passes)} passes; index build excluded, as "
        f"bench.py does)")
    # the assembly against the reference: a 2 Mbp random genome at 79x
    # with error-free reads is one unitig per strand
    lens = g.edge_len()
    longest = g.get_seq(int(np.argmax(lens))).tobytes()
    if not (genome.tobytes().find(longest) >= 0
            or tt.revcomp(genome).copy().tobytes().find(longest) >= 0):
        raise AssertionError("longest unitig is not a genome substring")
    if lens.max() < 0.999 * G:
        raise AssertionError(f"longest unitig {lens.max()} < 99.9% genome")
    if mapped < 0.99:
        raise AssertionError(f"only {mapped:.4f} of error-free reads mapped")
    if acc_indel < 0.95:
        raise AssertionError(f"only {acc_indel:.4f} of indel reads accepted")
    if pairs < 65_536 or launches < 1:
        raise AssertionError(f"remainder DP ran {pairs} pairs through the "
                             "NW kernel, expected >= 65536")
    m = e >= 0
    if not ((s[m] >= 0).all() and (s[m] < lens[e[m]]).all()):
        raise AssertionError("mapped starts outside their edges")
    profile_main_path(reads, lengths, ir, il, k)
    return launches


def build_kernels():
    from turingassembler_tpu_torch import _build
    t0 = time.perf_counter()
    logs = _build.build()
    log(f"build: {time.perf_counter() - t0:.2f} s ({', '.join(logs) or 'cached'})")
    for name, text in logs.items():
        print(f"[{name}] {text}", file=sys.stderr, flush=True)


def main():
    smi = device_info()
    build_kernels()

    nw = phase_kernel_vs_plain()
    phase_slice_parity()
    launches = phase_full_width()

    print(json.dumps({"kernels": [{
        "name": "nw_align", "route": "cuda",
        "source": "turingassembler_tpu_torch/csrc/nw_align.cu",
        "replaces": "turingassembler_tpu/ops/pallas_align.py:159",
        "launches": launches, "max_abs_err": nw["max_abs_err"],
        "ms": nw["ms"], "plain_ms": nw["plain_ms"],
        "bound_ms": nw["bound_ms"], "bound_by": nw["bound_by"],
        "library_ms": None}]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
