"""What holds the selective-scan kernels: their time with one cost taken out.

Builds ``src/repro_torch/kernels/csrc/selective_scan.cu`` as it is and in
probe copies, each with one edit that removes one cost (the results of
the copies are wrong by design), and times the fused and the bare
forward and the fused backward of each at one falcon-mamba-7b layer (B
2, S 2048, d_in 8192, d_state 16, bf16; the backward as training runs
it, h0 = 0 and no gradient of h_last) with CUDA events, in turns (as
built, the probes, then the same in reverse).  A cost whose removal
leaves the time where it was does not bind the kernel.

Forward probes:
  no_sfu_exp      each state exp (MUFU.EX2) replaced by one FMA
  no_tma_wait     tiles after the first ring never waited for nor loaded
  no_prologue_epilogue
                  the prologue (softplus, dt * x) and the epilogue (sum
                  of partial y, D skip, gate, store) run for the first
                  tile only
  bc_rows_once    pass 1 reads two Bm | Cm rows a tile, not eight

Backward probes:
  bwd_no_state_exp      each state exp (two a (t, channel, state): pass 1's
                        and pass 3's) replaced by one FMA
  bwd_no_tma_wait       tiles after the first ring never waited for nor
                        loaded
  bwd_no_channel_shuffles
                        dB | dC's reduce-scatter over the warp's channels
                        without its shuffles (each level adds the lane's
                        own values)
  bwd_no_cluster_sum    no block reads the others' tile sums nor writes
                        the partial rows
  bwd_no_cluster_barrier
                        that, and no cluster barrier either
  bwd_no_partials_barrier
                        no __syncthreads between the passes and the
                        epilogue (the one after the prologue stays: it
                        keeps the warps within a tile of each other, as
                        the TMA ring's parities need)
  bwd_no_epilogue_items the epilogue's (t, channel) items skipped (ddt,
                        dx, dz, dD, ddt_bias)
  bwd_no_prologue       the prologue (softplus, silu, dt * x) for the
                        first tile only

With ``--parent FILE.cu`` (an earlier revision of the source whose entry
points take the arguments this one's do, e.g. ``git show
REV:src/repro_torch/kernels/csrc/selective_scan.cu``) it also builds that
file, holds the fused forward as built to it bit for bit (out and
h_last), holds the backward as built (through the wrapper) to the plain
backward within chip_smoke's tolerances (not to the parent's bits: the
sums run in another order), and times each against the parent's in
turns (parent, as built, as built, parent).

Run on a machine with an NVIDIA card and the CUDA toolkit, from the
repository root::

    python3 tools/scan_probes.py [--out PATH] [--parent FILE.cu]

It prints one JSON object: the card (``nvidia-smi`` name and power
limit), each build's registers, spills and SASS opcode counts, and ms a
call per probe (and under ``parent`` the comparison).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import struct
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

SOURCE = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "selective_scan.cu"
OUT_DIR = ROOT / "build" / "scan_probes"
#: probe -> [(text in the source, its replacement)]; each text must occur
#: once
PROBES = {
    "as_built": [],
    "no_sfu_exp": [("const float a = ex2(d * a2[j]);",
                    "const float a = fmaf(d, a2[j], 1.f);")],
    "no_tma_wait": [
        ("    mbar_wait(bar0 + 8 * (k % STAGES), (k / STAGES) & 1);",
         "    if (k < STAGES)\n"
         "      mbar_wait(bar0 + 8 * (k % STAGES), (k / STAGES) & 1);"),
        ("    if (tid == 0 && k >= 2 && k + STAGES - 2 < n_tiles)",
         "    if (false)")],
    "no_prologue_epilogue": [
        ("#pragma unroll 1\n    for (int i = tid; i < CPB * T / 2;",
         "#pragma unroll 1\n    if (k == 0)\n"
         "    for (int i = tid; i < CPB * T / 2;"),
        ("#pragma unroll 1\n    for (int i = tid; i < T * CPB / 2;",
         "#pragma unroll 1\n    if (j == 0)\n"
         "    for (int i = tid; i < T * CPB / 2;")],
    "bc_rows_once": [
        ("      const float4 bv = ld4(pb + i * 2 * ST);\n"
         "      const float4 cv = ld4(pb + i * 2 * ST + ST);",
         "      const float4 bv = ld4(pb + (i & 1) * 2 * ST);\n"
         "      const float4 cv = ld4(pb + (i & 1) * 2 * ST + ST);")],
    "bwd_no_state_exp": [
        ("const float at = ex2(d * a2[j]);",
         "const float at = fmaf(d, a2[j], 1.f);"),
        ("const float ar = ex2(d * a2[j]);",
         "const float ar = fmaf(d, a2[j], 1.f);")],
    "bwd_no_tma_wait": [
        ("      bwd_wait(bar0 + 8 * (it % BWD_STAGES),",
         "      if (it < BWD_STAGES) bwd_wait(bar0 + 8 * (it % BWD_STAGES),"),
        ("      if (issuer && it - 1 + BWD_STAGES < n_tiles)",
         "      if (false)")],
    "bwd_no_channel_shuffles": [
        ("v[j] = keep + __shfl_xor_sync(FULL, send, 1 << G::LOG_P);",
         "v[j] = keep + send;"),
        ("v[j] = keep + __shfl_xor_sync(FULL, send, 2 << G::LOG_P);",
         "v[j] = keep + send;"),
        ("v[0] = keep + __shfl_xor_sync(FULL, send, 4 << G::LOG_P);",
         "v[0] = keep + send;")],
    "bwd_no_cluster_sum": [
        ("    if (!mine || (n_tiles - 1 - j) * T + t >= S)",
         "    if (true)")],
    "bwd_no_cluster_barrier": [
        ("      if (it % BWD_GROUP == 0) cluster_wait();\n"
         "      cl_take = cluster_load(it - BWD_GROUP);", ""),
        ("    if (it % BWD_GROUP == BWD_GROUP - 1 || it == n_tiles - 1)\n"
         "      cluster_arrive();", ""),
        ("  cluster_wait();\n#pragma unroll 1\n"
         "  for (int j = n_tiles > BWD_GROUP ? n_tiles - BWD_GROUP : 0;",
         "#pragma unroll 1\n  for (int j = n_tiles;")],
    "bwd_no_partials_barrier": [
        ("    // tile it's partials written\n    __syncthreads();", "")],
    "bwd_no_epilogue_items": [
        ("      for (int n = 0; n < G::NITEM; ++n) {",
         "      for (int n = 0; n < 0; ++n) {")],
    "bwd_no_prologue": [
        ("      for (int i = tid; i < CPB * T / 2; i += THREADS) {",
         "      for (int i = it ? CPB * T : tid; i < CPB * T / 2;\n"
         "           i += THREADS) {")],
}


def build_all() -> dict:
    """``{probe: (library path, its d_state 16 bf16 instances' registers,
    spills and SASS opcode counts, forward and backward)}``: each probe's
    copy of the source under ``build/scan_probes``, built by
    ``chip_smoke.sass_of`` (the
    port's nvcc flags), all at once.  A probe whose text no longer occurs
    once in the source stops the tool: its edit follows the kernel's."""
    import chip_smoke
    sources = {}
    for name, edits in PROBES.items():
        text = SOURCE.read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"probe {name}: the edit's text occurs "
                                 f"{text.count(old)} times in {SOURCE.name}")
            text = text.replace(old, new)
        OUT_DIR.mkdir(parents=True, exist_ok=True)
        sources[name] = OUT_DIR / f"{SOURCE.stem}_{name}.cu"
        sources[name].write_text(text)
    with ThreadPoolExecutor(len(sources)) as pool:    # nvcc in parallel
        built = dict(zip(sources, pool.map(chip_smoke.sass_of,
                                           map(str, sources.values()))))
    return {name: (Path(b["library"]),
                   {k: v for k, v in b["kernels"].items() if "<16, bf16" in k})
            for name, b in built.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="also write the result here")
    ap.add_argument("--parent", default=None, metavar="FILE.cu",
                    help="an earlier revision of the source to hold the "
                         "fused entry point to, bit for bit and in time")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("scan_probes: needs an NVIDIA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import ref, selective_scan as ss

    builds = build_all()
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 22)
    B, S, d_in, st = 2, 2048, 8192, 16
    fargs = cs._fused_inputs(B, S, d_in, st, torch.bfloat16, gen, True)
    h0, dt, Bm, Cm, A, xc, D, z, bias = fargs
    bh0, bdt, bBm, bCm, bA, bx = cs._scan_inputs(
        B, S, d_in, st, torch.bfloat16, gen, True)
    bc, bcs = ss._bc_rows(Bm, Cm)
    bbc, bbcs = ss._bc_rows(bBm, bCm)
    out = torch.empty((B, S, d_in), dtype=torch.bfloat16, device="cuda")
    y = torch.empty((B, S, d_in), device="cuda")
    hl = torch.empty((B, d_in, st), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    # the fused entry point as a prefill calls it: no tile states
    fused_args = struct.pack(
        "<19q", dt.data_ptr(), xc.data_ptr(), z.data_ptr(), bc.data_ptr(),
        A.data_ptr(), 0, D.data_ptr(), bias.data_ptr(), out.data_ptr(),
        hl.data_ptr(), 0, B, S, d_in, st, bcs, z.stride(1), 1, stream)
    bare_args = struct.pack(
        "<14q", bdt.data_ptr(), bx.data_ptr(), bbc.data_ptr(), bA.data_ptr(),
        bh0.data_ptr(), y.data_ptr(), hl.data_ptr(), B, S, d_in, st, bbcs, 1,
        stream)
    # the backward as training calls it, from the forward's tile states;
    # its partials sized for one row of 32 channels (the most any revision
    # writes)
    _, _, states = ss.selective_scan_fused_forward(*fargs, save_states=True)
    dout = torch.randn((B, S, d_in), generator=gen, device="cuda").to(
        torch.bfloat16)

    def bwd_pack():
        grads = [torch.empty((B, S, d_in), dtype=torch.bfloat16,
                             device="cuda") for _ in range(3)]
        part = torch.empty((-(-d_in // ss.CHANNELS_PER_BLOCK), B, S, 2 * st),
                           device="cuda")
        red = torch.empty((B, d_in * (st + 2)), device="cuda")
        keep = (grads, part, red)
        return keep, struct.pack(
            "<24q", dt.data_ptr(), xc.data_ptr(), z.data_ptr(),
            bc.data_ptr(), A.data_ptr(), D.data_ptr(), bias.data_ptr(),
            dout.data_ptr(), 0, states.data_ptr(), *(g.data_ptr()
                                                     for g in grads),
            part.data_ptr(), red.data_ptr(), 0, B, S, d_in, st, bcs,
            z.stride(1), 1, stream)

    bwd_keep, bwd_args = bwd_pack()
    entries = ("selective_scan_fused", "selective_scan_forward",
               "selective_scan_fused_backward")

    def bind(path) -> tuple:
        dll = ctypes.CDLL(str(path))
        for entry in entries:
            getattr(dll, entry).argtypes = [ctypes.c_char_p]
            getattr(dll, entry).restype = ctypes.c_int
        return tuple(getattr(dll, e) for e in entries)

    fns = {name: bind(lib) for name, (lib, _) in builds.items()}

    def ms(fn, packed, iters=50) -> float:
        for _ in range(3):
            if fn(packed):
                raise SystemExit("launch refused")
        torch.cuda.synchronize()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(iters):
            fn(packed)
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / iters

    times: dict = {name: {"fused_ms": [], "bare_ms": [], "backward_ms": []}
                   for name in fns}
    order = list(fns)
    for name in order + order[::-1]:
        fused, bare, bwd = fns[name]
        times[name]["fused_ms"].append(ms(fused, fused_args))
        times[name]["bare_ms"].append(ms(bare, bare_args))
        times[name]["backward_ms"].append(ms(bwd, bwd_args, iters=20))
    rec = {"card": cs.card_line(), "shape": {"B": B, "S": S, "d_in": d_in,
                                             "d_state": st,
                                             "dtype": "bfloat16"},
           "probes": {name: {**times[name], "kernels": regs}
                      for name, (_, regs) in builds.items()}}
    if args.parent:
        parent, _, parent_bwd = bind(cs.sass_of(args.parent)["library"])
        out_p, hl_p = torch.empty_like(out), torch.empty_like(hl)
        parent_args = struct.pack(
            "<19q", dt.data_ptr(), xc.data_ptr(), z.data_ptr(),
            bc.data_ptr(), A.data_ptr(), 0, D.data_ptr(), bias.data_ptr(),
            out_p.data_ptr(), hl_p.data_ptr(), 0, B, S, d_in, st, bcs,
            z.stride(1), 1, stream)
        ours, _, ours_bwd = fns["as_built"]
        if ours(fused_args) or parent(parent_args):
            raise SystemExit("launch refused")
        torch.cuda.synchronize()
        turns = [ms(f, a) for f, a in ((parent, parent_args),
                                       (ours, fused_args),
                                       (ours, fused_args),
                                       (parent, parent_args))]
        p_keep, p_bwd_args = bwd_pack()
        bturns = [ms(f, a, iters=20) for f, a in (
            (parent_bwd, p_bwd_args), (ours_bwd, bwd_args),
            (ours_bwd, bwd_args), (parent_bwd, p_bwd_args))]
        # the backward as built (the wrapper's library, the same source)
        # against the plain backward, within chip_smoke's tolerances
        got = ss.selective_scan_fused_backward(*fargs, dout, None, states)
        want = ref.selective_scan_fused_backward(*fargs, dout)
        err = cs._bwd_close(got, want, "backward as built")
        rec["parent"] = {"source": args.parent,
                         "same_bits": bool(torch.equal(out, out_p)
                                           and torch.equal(hl, hl_p)),
                         "parent_fused_ms": [turns[0], turns[3]],
                         "as_built_fused_ms": [turns[1], turns[2]],
                         "parent_backward_ms": [bturns[0], bturns[3]],
                         "as_built_backward_ms": [bturns[1], bturns[2]],
                         "backward_max_abs_err": err}
        del p_keep
    del bwd_keep
    print(json.dumps(rec), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rec, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
