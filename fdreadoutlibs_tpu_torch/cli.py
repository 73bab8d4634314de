"""Validation / emulation CLI.

Port of ``fdreadoutlibs_tpu/cli.py:1-553``: every command, with the same
arguments and defaults (the trace directory under the temporary
directory) and the same printed JSON keys.  ``tpg-emulator``,
``compare-backends`` and ``profile`` take ``--device`` (default ``cuda``,
which raises without a card; ``cpu`` runs the kernels' plain versions).
``profile`` captures the production kernel on plain samples (K2; K3 for
``-a FIR``, K5 with ``--fir-twopass 1`` or ``2``) under
``utils.logging.device_trace`` (``torch.profiler``); ``--unroll`` is
accepted and unused (a TPU knob).

Covers the reference's documented tooling (docs/README.md:20-121):

* ``tpg-emulator``     — wibeth_tpg_algorithms_emulator: replay a WIBEth
  binary through a TPG algorithm/backend, with --save-adc-data /
  --save-trigprim and a throughput report;
* ``pattern-generator``— wibeth_tpg_pattern_generator: write pattern
  binaries (golden/pulse/edge_*) onto an input file's timestamps;
* ``frame-reader``     — wibeth_binary_frame_reader: dump frame headers/ADCs;
* ``frame-modifier``   — wibeth_binary_frame_modifier: patch ADCs/headers;
* ``compare-backends`` — compare_avx_vs_naive.py: cross-check hit lists
  between backends (here: reference vs scan vs pallas);
* ``make-zeros``       — generate the all-zeros asset file;
* ``profile``          — beyond the reference's wall-clock timing runs:
  capture a device trace of the production kernel.

Run: ``python -m fdreadoutlibs_tpu_torch.cli <command> -h``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np


def _load_wibeth(path):
    from .formats import wibeth
    from .stream.emulator import FileSourceBuffer
    buf = FileSourceBuffer(wibeth.FRAME_SIZE)
    return buf.read(path)


def cmd_tpg_emulator(args) -> int:
    from .formats import wibeth
    from .models import run_model
    from .ops import TPGConfig

    frames = _load_wibeth(args.file)
    if args.num_frames_to_read > 0:
        frames = frames[: args.num_frames_to_read]
    adcs = wibeth.get_adcs(frames).reshape(-1, wibeth.N_CHANNELS) \
        .astype(np.int32)
    ts0 = int(wibeth.get_timestamp(frames)[0])
    cfg = TPGConfig.from_raw(algorithm=args.algorithm,
                             threshold=args.threshold,
                             rs_memory_factor=args.rs_memory_factor,
                             rs_scale_factor=args.rs_scale_factor)
    t_start = time.perf_counter()
    n_runs = max(1, args.repeat)
    for _ in range(n_runs):
        hits, _ = run_model(adcs, cfg, backend=args.implementation,
                            device=args.device)
    wall = (time.perf_counter() - t_start) / n_runs
    data_seconds = adcs.shape[0] * 32 / 62.5e6

    if args.save_adc_data:
        np.savetxt(args.save_adc_data, adcs, fmt="%d", delimiter=",")
        print(f"ADC data -> {args.save_adc_data}")
    if args.save_trigprim:
        with open(args.save_trigprim, "w") as f:
            f.write("channel,time_start,time_over_threshold,time_peak,"
                    "adc_integral,adc_peak,type\n")
            for h in hits:
                t_begin = ts0 + 32 * (int(h["end_tick"]) - int(h["tover"]))
                f.write(f"{int(h['channel'])},{t_begin},{32 * int(h['tover'])},"
                        f"{t_begin + 32 * int(h['peak_time'])},"
                        f"{int(h['charge'])},{int(h['peak_adc'])},1\n")
        print(f"TPs -> {args.save_trigprim}")

    print(json.dumps({
        "frames": len(frames), "channels": wibeth.N_CHANNELS,
        "algorithm": args.algorithm, "implementation": args.implementation,
        "hits": len(hits), "wall_seconds": round(wall, 6),
        "realtime_factor": round(data_seconds / wall, 3),
    }))
    return 0


def cmd_pattern_generator(args) -> int:
    from .stream.emulator import pattern_file
    ts0 = 0x66583B8C7E967
    if args.file:
        from .formats import wibeth
        frames = _load_wibeth(args.file)
        ts0 = int(wibeth.get_timestamp(frames)[0])
    out = args.output or f"patt_{args.pattern}_{args.time_tick_offset}" \
        "_wibeth_output.bin"
    pattern_file(out, args.pattern, n_frames=args.num_frames_to_read or 2,
                 channel=args.input_channel, offset=args.time_tick_offset,
                 first_timestamp=ts0)
    print(f"pattern '{args.pattern}' -> {out}")
    if args.save_trigprim:
        ns = argparse.Namespace(
            file=out, num_frames_to_read=0, algorithm="SimpleThreshold",
            threshold=args.threshold, rs_memory_factor=0.8,
            rs_scale_factor=2.0, implementation="reference", repeat=1,
            save_adc_data=None, device="cpu",
            save_trigprim=out.replace(".bin", "_tps.txt"))
        return cmd_tpg_emulator(ns)
    return 0


def cmd_frame_reader(args) -> int:
    from .formats import wibeth
    frames = _load_wibeth(args.file)
    n = min(len(frames), args.num_frames_to_read or len(frames))
    for i in range(n):
        f = frames[i:i + 1]
        print(f"frame {i}: ts={int(wibeth.get_timestamp(f)[0])} "
              f"seq={int(wibeth.get_header_field(f, 'seq_id')[0])} "
              f"crate={int(wibeth.get_header_field(f, 'crate_id')[0])} "
              f"slot={int(wibeth.get_header_field(f, 'slot_id')[0])} "
              f"stream={int(wibeth.get_header_field(f, 'stream_id')[0])}")
        if args.dump_adcs:
            adcs = wibeth.get_adcs(f)[0]
            for t in range(0, 64, args.adc_stride):
                print(" ", " ".join(f"{v:5d}" for v in adcs[t]))
    return 0


def cmd_frame_modifier(args) -> int:
    from .formats import wibeth
    frames = _load_wibeth(args.file).copy()
    if args.set_channel is not None:
        adcs = wibeth.get_adcs(frames)
        adcs[..., args.set_channel] = args.set_value
        wibeth.set_adcs(frames, adcs)
    if args.set_timestamp is not None:
        wibeth.fake_timestamps(frames, args.set_timestamp)
    out = args.output or args.file.replace(".bin", "_modified.bin")
    frames.tofile(out)
    print(f"modified {len(frames)} frames -> {out}")
    return 0


def cmd_compare_backends(args) -> int:
    """compare_avx_vs_naive.py equivalent: assert hit-list equality."""
    from .formats import wibeth
    from .models import run_model
    from .ops import TPGConfig
    frames = _load_wibeth(args.file)
    adcs = wibeth.get_adcs(frames).reshape(-1, wibeth.N_CHANNELS) \
        .astype(np.int32)
    cfg = TPGConfig.from_raw(algorithm=args.algorithm,
                             threshold=args.threshold)
    results = {}
    for backend in args.backends:
        hits, _ = run_model(adcs, cfg, backend=backend, device=args.device)
        results[backend] = hits
        print(f"{backend}: {len(hits)} hits")
    base = args.backends[0]
    ok = True
    for other in args.backends[1:]:
        same = np.array_equal(results[base], results[other])
        print(f"{base} vs {other}: {'MATCH' if same else 'MISMATCH'}")
        ok &= same
    return 0 if ok else 1


def cmd_compare_tp_files(args) -> int:
    """compare_avx_vs_naive.py file mode: diff two saved TP text files."""
    import csv

    def load(path):
        with open(path) as f:
            return sorted(tuple(int(v) for v in row.values() if v != "")
                          for row in csv.DictReader(f))

    a, b = load(args.files[0]), load(args.files[1])
    only_a = [r for r in a if r not in set(b)]
    only_b = [r for r in b if r not in set(a)]
    print(f"{args.files[0]}: {len(a)} TPs; {args.files[1]}: {len(b)} TPs")
    for r in only_a[:10]:
        print(f"  only in {args.files[0]}: {r}")
    for r in only_b[:10]:
        print(f"  only in {args.files[1]}: {r}")
    ok = not only_a and not only_b
    print("MATCH" if ok else f"MISMATCH ({len(only_a)}+{len(only_b)} diffs)")
    return 0 if ok else 1


def cmd_make_zeros(args) -> int:
    from .stream.emulator import all_zeros_wibeth_file
    all_zeros_wibeth_file(args.output, n_frames=args.num_frames)
    print(f"all-zeros file ({args.num_frames} frames) -> {args.output}")
    return 0


def cmd_fragment_dump(args) -> int:
    """Inspect a FragmentRecorder store: list the index, or extract one
    fragment's raw payloads to a frame binary (replayable through
    frame-reader / tpg-emulator)."""
    from .tp.recorder import FragmentRecorder
    rec = FragmentRecorder(args.store)
    if args.index < 0:
        for i, meta in enumerate(rec.index()):
            print(json.dumps({"i": i, **meta}))
        return 0
    try:
        frag = rec.read(args.index)
    except IndexError:
        print(f"error: fragment index {args.index} out of range "
              f"(store has {len(rec)})", file=sys.stderr)
        return 2
    if args.output:
        frag.payloads.tofile(args.output)
        print(f"fragment {args.index}: {len(frag)} payloads "
              f"({frag.size_bytes} B) -> {args.output}")
    else:
        print(json.dumps({k: getattr(frag.header, k) for k in
                          ("run_number", "trigger_number", "window_begin",
                           "window_end", "source_id", "fragment_type")},
                         default=str))
    return 0


def cmd_tde_file_creator(args) -> int:
    """Port of test/apps/tde_file_creator.cxx: shuffled TDE16 frames
    (batches x 12 AMCs x 64 channels) exercising out-of-order, per-channel
    timestamp handling."""
    from .formats import tde
    rng = np.random.default_rng(args.seed)
    all_frames = []
    for batch in range(args.num_batches):
        frames = tde.empty_frames(12 * 64)
        i = 0
        for amc in range(12):
            for ch in range(64):
                f = frames[i:i + 1]
                tde.set_timestamp(f, batch)
                tde.set_daq_header_field(f, "slot_id", amc)
                tde.set_daq_header_field(f, "stream_id", ch)
                tde.set_channel(f, ch)
                tde.set_adc_sample(f, batch, 0)
                i += 1
        rng.shuffle(frames, axis=0)
        all_frames.append(frames)
    out = np.concatenate(all_frames)
    out.tofile(args.output)
    print(f"{len(out)} shuffled TDE frames -> {args.output}")
    return 0


def cmd_profile(args) -> int:
    """Capture a ``torch.profiler`` trace of the production kernel over a
    synthetic APA stream of plain samples (K2; K3 for FIR, K5 with
    ``--fir-twopass``) on ``--device`` — the reference's analogue is the
    core-pinned emulator timing runs (docs/README.md:22); this one captures
    per-kernel device timelines instead of wall clock only.  The first
    launch (the kernel library's build and load) stays outside the
    trace."""
    import torch
    from .apps.apa_readout import resolve_device
    from .ops import TPGConfig
    from .ops.chanstate import init_chanstate, seed_chanstate
    from .ops.tpg import auto_tc, pack_state, process_window
    from .utils.logging import device_trace

    dev = resolve_device(args.device)
    C, T = args.channels, args.ticks
    cfg = TPGConfig.from_raw(args.algorithm, threshold=args.threshold,
                             **({"track_peaks": False}
                                if args.algorithm == "FIR" else {}))
    rng = np.random.default_rng(0)
    adcs = (900 + rng.normal(0, 30, size=(T, C))).astype(np.int32)
    for _ in range(max(1, C // 16)):
        c, t0 = rng.integers(0, C), rng.integers(0, T - 16)
        adcs[t0:t0 + 8, c] += rng.integers(300, 3000)
    feed = torch.from_numpy(adcs).to(dev)
    state = pack_state(
        seed_chanstate(init_chanstate(C), adcs[0], cfg.rs_memory_factor_x10),
        C, device=dev)
    tc = auto_tc(T, cap=args.tc)

    def run(s):
        return process_window(feed, s, cfg, tc=tc, k_slots=args.k_slots,
                              time_packed=False,
                              fir_twopass=args.fir_twopass)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    run(state)                      # build and load outside the trace
    sync()
    t0 = time.perf_counter()
    with device_trace(args.output):
        s = state
        for _ in range(args.windows):
            _, nclose, s = run(s)
        sync()
    dt = time.perf_counter() - t0
    gsps = args.windows * T * C / dt / 1e9
    print(json.dumps({
        "trace_dir": args.output,
        "backend": torch.cuda.get_device_name(dev) if dev.type == "cuda"
        else "cpu",
        "algorithm": args.algorithm, "channels": C, "ticks": T,
        "windows": args.windows, "wall_s": round(dt, 4),
        "gsps_wall": round(gsps, 6),
        "note": "open with Perfetto or chrome://tracing "
                "(trace.json under the trace dir)"}))
    if args.top:
        for line in summarize_trace(args.output, args.top):
            print(line)
    return 0


def summarize_trace(trace_dir: str, top: int = 10):
    """Aggregate the captured Chrome-trace events by name and yield the
    top-N rows by total duration (self-contained — no viewer)."""
    from .utils.logging import TRACE_FILE

    path = os.path.join(trace_dir, TRACE_FILE)
    if not os.path.exists(path):
        yield f"# no {TRACE_FILE} found under trace dir"
        return
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    total: dict[str, float] = {}
    count: dict[str, int] = {}
    for ev in events:
        if ev.get("ph") == "X" and "dur" in ev:
            name = ev.get("name", "?")
            total[name] = total.get(name, 0.0) + ev["dur"]
            count[name] = count.get(name, 0) + 1
    yield "# top ops by total device/host time"
    yield "#   us_total  calls  name"
    for name in sorted(total, key=total.get, reverse=True)[:top]:
        yield f"{total[name]:11.1f}  {count[name]:5d}  {name[:90]}"


def cmd_channel_map(args) -> int:
    """Dump a channel map's (crate, slot, stream) -> offline/plane layout —
    the inspection the reference logs via RegisterToChannelNumber's
    TLVL_BOOKKEEPING trace."""
    from .utils.channel_map import TableChannelMap, make_map
    if args.file:
        m = TableChannelMap.from_file(args.file)
    else:
        kw = {"frontend": args.frontend} if args.frontend else {}
        m = make_map(args.name, **kw)
    if getattr(args, "write_dump", None):
        from .utils.channel_map import write_detchannelmaps_dump
        n = write_detchannelmaps_dump(
            m, args.write_dump, crate=args.crate,
            frontend=args.frontend or "wibeth",
            header=f"dump of {args.name or args.file} crate={args.crate} "
                   f"(fdreadoutlibs_tpu channel-map --write-dump)")
        print(json.dumps({"written": args.write_dump, "rows": n}))
        return 0
    offl = m.offline_channels(args.crate, args.slot, args.stream,
                              args.channels)
    planes = m.planes(offl)
    plane_names = {0: "X(coll)", 1: "U", 2: "V"}
    if args.json:
        print(json.dumps({"offline": offl.tolist(),
                          "plane": planes.tolist()}))
    else:
        print(f"# {args.name or args.file} crate={args.crate} "
              f"slot={args.slot} stream={args.stream}")
        print("# chan offline plane")
        for c in range(args.channels):
            print(f"{c:4d} {offl[c]:8d}  {plane_names.get(int(planes[c]), planes[c])}")
    return 0


def cmd_validate_map(args) -> int:
    """Cross-check a detchannelmaps-format dump file against the
    geometry-derived map (the channel-map fidelity harness): confirms the
    derivation or pins the exact divergences; optionally derives the
    production femb_table from the dump."""
    from .utils.channel_map import (HDAPAChannelMap, TableChannelMap,
                                    cross_check_maps, femb_table_from_dump,
                                    frontend_geometry)
    n_streams, width = frontend_geometry(args.frontend)
    tbl = TableChannelMap.from_file(args.file, channels_per_stream=width)
    geo = HDAPAChannelMap(frontend=args.frontend)
    keys = [(args.crate, s, st) for s in range(HDAPAChannelMap.N_WIBS)
            for st in range(n_streams)
            if (args.crate, s, st) in tbl.table]
    if not keys:
        print(json.dumps({"match": False, "n_checked": 0,
                          "error": f"dump has no rows for crate "
                                   f"{args.crate} (pass --crate?)"}))
        return 2
    rep = cross_check_maps(tbl, geo, keys, n_channels=width)
    out = dict(rep)
    if args.derive_femb_table:
        try:
            table = femb_table_from_dump(args.file, crate=args.crate,
                                         frontend=args.frontend)
            out["femb_table"] = table.tolist()
            derived = HDAPAChannelMap(femb_table=table,
                                      frontend=args.frontend)
            out["derived_matches"] = cross_check_maps(
                tbl, derived, keys, n_channels=width)["match"]
        except ValueError as e:
            out["femb_table_error"] = str(e)
    print(json.dumps(out))
    # success = the geometry map matched outright, or a derived femb
    # table was requested AND reproduces the dump (scripts gating on the
    # exit code must not treat a divergent, underivable map as valid)
    return 0 if rep["match"] or out.get("derived_matches") else 1


def _device_arg(parser) -> None:
    parser.add_argument("--device", default="cuda",
                        help="torch device: cuda (the kernels; needs a card) "
                             "or cpu (their plain versions)")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="fdreadoutlibs_tpu_torch",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="command", required=True)

    e = sub.add_parser("tpg-emulator", help="run TPG over a frame file")
    e.add_argument("-f", "--file", required=True)
    e.add_argument("-a", "--algorithm", default="SimpleThreshold",
                   choices=["SimpleThreshold", "AbsRS", "StandardRS", "FIR"])
    e.add_argument("-i", "--implementation", default="scan",
                   choices=["reference", "scan", "pallas"])
    e.add_argument("-n", "--num-frames-to-read", type=int, default=-1)
    e.add_argument("-t", "--threshold", type=int, default=499)
    e.add_argument("--rs-memory-factor", type=float, default=0.8)
    e.add_argument("--rs-scale-factor", type=float, default=2.0)
    e.add_argument("-d", "--repeat", type=int, default=1,
                   help="repeat runs for timing")
    e.add_argument("--save-adc-data", metavar="CSV")
    e.add_argument("--save-trigprim", metavar="TXT")
    _device_arg(e)
    e.set_defaults(fn=cmd_tpg_emulator)

    g = sub.add_parser("pattern-generator", help="write pattern binaries")
    g.add_argument("-f", "--file", help="input file providing timestamps")
    g.add_argument("-p", "--pattern", default="golden",
                   choices=["golden", "pulse", "edge_square", "edge_left",
                            "edge_right"])
    g.add_argument("-n", "--num-frames-to-read", type=int, default=2)
    g.add_argument("-i", "--input-channel", type=int, default=0)
    g.add_argument("-o", "--time-tick-offset", type=int, default=1)
    g.add_argument("-t", "--threshold", type=int, default=499)
    g.add_argument("--output")
    g.add_argument("--save-trigprim", action="store_true")
    g.set_defaults(fn=cmd_pattern_generator)

    r = sub.add_parser("frame-reader", help="dump frame headers/ADCs")
    r.add_argument("-f", "--file", required=True)
    r.add_argument("-n", "--num-frames-to-read", type=int, default=4)
    r.add_argument("--dump-adcs", action="store_true")
    r.add_argument("--adc-stride", type=int, default=16)
    r.set_defaults(fn=cmd_frame_reader)

    m = sub.add_parser("frame-modifier", help="patch a frame file")
    m.add_argument("-f", "--file", required=True)
    m.add_argument("--set-channel", type=int)
    m.add_argument("--set-value", type=int, default=0)
    m.add_argument("--set-timestamp", type=int)
    m.add_argument("--output")
    m.set_defaults(fn=cmd_frame_modifier)

    c = sub.add_parser("compare-backends",
                       help="cross-check hit lists between backends")
    c.add_argument("-f", "--file", required=True)
    c.add_argument("-a", "--algorithm", default="SimpleThreshold")
    c.add_argument("-t", "--threshold", type=int, default=499)
    c.add_argument("-b", "--backends", nargs="+",
                   default=["reference", "scan"])
    _device_arg(c)
    c.set_defaults(fn=cmd_compare_backends)

    cf = sub.add_parser("compare-tp-files",
                        help="diff two saved TP text files")
    cf.add_argument("files", nargs=2)
    cf.set_defaults(fn=cmd_compare_tp_files)

    fd = sub.add_parser("fragment-dump",
                        help="list / extract recorded Fragments")
    fd.add_argument("store", help="FragmentRecorder directory")
    fd.add_argument("-i", "--index", type=int, default=-1,
                    help="fragment index (default: list all)")
    fd.add_argument("-o", "--output", default=None,
                    help="write payloads to this frame binary")
    fd.set_defaults(fn=cmd_fragment_dump)

    z = sub.add_parser("make-zeros", help="generate the all-zeros asset")
    z.add_argument("-o", "--output", default="wibeth_output_all_zeros.bin")
    z.add_argument("-n", "--num-frames", type=int, default=32)
    z.set_defaults(fn=cmd_make_zeros)

    t = sub.add_parser("tde-file-creator",
                       help="write shuffled TDE frames (tde_file_creator)")
    t.add_argument("-o", "--output", default="frames.bin")
    t.add_argument("-n", "--num-batches", type=int, default=5)
    t.add_argument("--seed", type=int, default=0)
    t.set_defaults(fn=cmd_tde_file_creator)

    cm = sub.add_parser("channel-map",
                        help="dump offline-channel/plane layout for a "
                             "(crate, slot, stream)")
    cm.add_argument("-n", "--name", default="HDAPAChannelMap")
    cm.add_argument("-f", "--file", default=None,
                    help="load a detchannelmaps-style table file instead")
    cm.add_argument("--crate", type=int, default=0)
    cm.add_argument("--slot", type=int, default=0)
    cm.add_argument("--stream", type=int, default=0)
    cm.add_argument("--channels", type=int, default=64)
    cm.add_argument("--frontend", default=None, choices=["wibeth", "wib2"],
                    help="electronics framing for geometry-derived maps "
                         "(wib2 = 2 links x 256 ch per WIB)")
    cm.add_argument("--json", action="store_true")
    cm.add_argument("--write-dump", metavar="PATH",
                    help="write the full crate as a detchannelmaps-format "
                         "dump (the generator for the packaged default "
                         "data/PD2HD_APA_wibeth.txt)")
    cm.set_defaults(fn=cmd_channel_map)

    vm = sub.add_parser("validate-map",
                        help="cross-check a detchannelmaps dump file "
                             "against the geometry-derived HD map")
    vm.add_argument("-f", "--file", required=True)
    vm.add_argument("--crate", type=int, default=0)
    vm.add_argument("--frontend", default="wibeth",
                    choices=["wibeth", "wib2"])
    vm.add_argument("--derive-femb-table", action="store_true",
                    help="also derive the exact femb_table from the dump "
                         "(for HDAPAChannelMap(femb_table=...) injection)")
    vm.set_defaults(fn=cmd_validate_map)

    pr = sub.add_parser("profile",
                        help="capture a torch.profiler device trace of "
                             "the production kernel")
    pr.add_argument("-a", "--algorithm", default="AbsRS",
                    choices=["SimpleThreshold", "AbsRS", "StandardRS", "FIR"])
    pr.add_argument("-t", "--threshold", type=int, default=150)
    pr.add_argument("-o", "--output", default=os.path.join(
        tempfile.gettempdir(), "fdreadout_trace"))
    pr.add_argument("--channels", type=int, default=2560)
    pr.add_argument("--ticks", type=int, default=2048)
    pr.add_argument("--windows", type=int, default=4)
    pr.add_argument("--tc", type=int, default=512)
    pr.add_argument("--k-slots", type=int, default=1)
    pr.add_argument("--unroll", type=int, default=32,
                    help="accepted and unused (a TPU knob)")
    pr.add_argument("--fir-twopass", type=int, default=0,
                    choices=(0, 1, 2),
                    help="FIR kernel schedule: 0 fused, 1 two-pass, "
                         "2 two-pass + lifted emission")
    pr.add_argument("--top", type=int, default=10,
                    help="print the top-N trace ops by total time "
                         "(0 = skip the summary)")
    _device_arg(pr)
    pr.set_defaults(fn=cmd_profile)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
