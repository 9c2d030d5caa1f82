"""The port's spans on the card, against the same traced windows without
them: every cell's ``--trace 1`` window through
``csr5_bench.harness.run_cell``, in turns as shipped (``on``) and with the
trace module's recording patched off from this script (``off``).

    python3 scripts/trace_ab.py [--cells A,B] [--turns on,off,off,on] [--seed N]
                                [--out chiprun_out/trace_ab.jsonl]

Each window runs in a process of its own, as the benchmark's runs do.

For each run it prints and writes one JSON line: the per-layer metrics,
the calls in the traced window, and, from the traced window itself, the
replays the capture records attribute (of all replays), the share of
``csr5.graph.launch`` spans that enclose exactly one ``cudaGraphLaunch``,
the anchors' narrowest bracket and the offsets they leave open, the
idle inside the graphs and between them against the whole window's, and
the device events named after a port span (there must be none), and the
operations of each product the records place. In the solve cells it also
measures with no profiler running, after the traced window: the host
clock around 100 ``graph.replay()`` calls, and the device's idle share
untraced, as phase 11 of ``chip_smoke.py`` takes it: the device busy time
per solve of the traced window against the time per solve by CUDA events
over 2 s of the same loop of solves, untraced. Needs a CUDA card.
"""

import argparse
import collections
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

CELLS = ("hpcg192.cg50", "kron23.pagerank20", "hpcg192.spmv", "kron23.spmm16")


def window_facts(t) -> dict:
    """What the traced window shows of the port's spans."""
    from csr5_bench import harness, replays
    from benchmark_spmv_using_csr5_tpu_torch.utils import trace

    facts = {"span_named_device_ops": sum(1 for n, _, _ in t.device_ops if n.startswith("csr5."))}
    fit = trace.clock_fit(t.host_ops)
    got = trace.on_profiler_clock(t.host_ops) or []
    facts.update(anchors=sum(1 for n, _, _ in t.host_ops if n == trace.ANCHOR),
                 bracket_us=fit and fit[2], offset_spread_us=fit and fit[3],
                 rate=fit and fit[1] / 1000, spans={})
    for s in got:
        facts["spans"][s.name] = facts["spans"].get(s.name, 0) + 1
    launches = [s for s in got if s.name == "csr5.graph.launch"]
    if launches:
        hosts = sorted((s, e) for n, s, e in t.host_ops if n == "cudaGraphLaunch")
        one = sum(1 for s in launches
                  if sum(1 for h0, h1 in hosts if s.start <= h0 and h1 <= s.end) == 1)
        facts["launch_spans_enclosing_one_graph_launch"] = one / len(launches)
    if t.kind == "solve":
        facts["busy_us_per_solve"] = 1e6 * t.busy_s / t.calls
        solves = [s for s in got if s.name == "csr5.solve"]
        reps = replays.replays(t)
        facts.update(replays_in_window=sum(1 for s in solves if s.attrs.get("mode") == "replay"),
                     replays_attributed=len(reps) if reps else 0)
        if not reps and solves:  # what lies between the first spans, to see why
            ops = sorted(t.device_ops, key=lambda o: o[1])
            cuts = [s.start for s in solves[:4]]
            runs = [[o for o in ops if a <= o[1] < b] for a, b in zip(cuts, cuts[1:])]
            facts["unattributed"] = {
                "ops_between_first_spans": [len(r) for r in runs],
                "ops_before_first_span": sum(1 for o in ops if o[1] < cuts[0]),
                "ops_in_window": len(ops),
                "records": {p: (r.inputs, r.nodes, r.outputs) for p, r in trace.captures().items()},
                "modes": [s.attrs for s in solves[:3]],
                "first_run": [(n[:40], round(s - cuts[0], 1)) for n, s, _ in runs[0][:4]]
                + [(n[:40], round(s - cuts[0], 1)) for n, s, _ in runs[0][-4:]] if runs else None}
        if reps:
            busy, gaps = harness._union_s(t.device_ops)
            inside = [(min(s for _, s, _ in r.nodes), max(e for _, _, e in r.nodes)) for r in reps]
            between = sum(g1 - g0 for g0, g1 in gaps
                          if not any(a <= g0 and g1 <= b for a, b in inside)) * 1e-6
            # idle before the window's first device operation and after its last
            edges = t.window_s - (max(e for _, _, e in t.device_ops)
                                  - min(s for _, s, _ in t.device_ops)) * 1e-6
            parts = replays.split(reps)
            if parts:
                names = collections.Counter(
                    tuple(n[:48] for n, _, _ in p) for p in parts[0])
                facts["products"] = {"count": len(parts[0]), "ops": [list(k) + [v] for k, v in
                                                                     names.items()]}
            r0 = reps[0]
            facts.update(
                idle_pct=100 * (1 - busy / t.window_s),
                idle_between_replays_pct=100 * between / t.window_s,
                idle_window_edges_pct=100 * edges / t.window_s,
                record={"solver": r0.record.solver, "inputs": r0.record.inputs,
                        "outputs": r0.record.outputs, "nodes": r0.record.nodes,
                        "launches": r0.record.launches,
                        "products": {k: len(v) for k, v in (r0.record.products or {}).items()}},
                first_replay_ops=[n[:48] for n, _, _ in r0.copies + r0.nodes[:6] + r0.clones])
    return facts


def time_replays(fn, n=100) -> dict:
    """The host clock around ``n`` calls of ``graph.replay()`` of the
    solver's newest program, each followed by a synchronisation, with no
    profiler running (µs: median, lowest, highest)."""
    import torch

    if not fn.cache.programs:
        return None
    prog = next(reversed(fn.cache.programs.values()))
    torch.cuda.synchronize()
    us = []
    for _ in range(n):
        t0 = time.perf_counter()
        prog.graph.replay()
        us.append((time.perf_counter() - t0) * 1e6)
        torch.cuda.synchronize()
    return {"median": statistics.median(us), "min": min(us), "max": max(us)}


def untraced_window(runner, seconds=2.0) -> dict:
    """The loop of solves the traced window ran, for ``seconds`` with no
    profiler: its solves, and its time by CUDA events per solve (µs)."""
    import torch

    sync = torch.cuda.synchronize
    sync()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    calls = runner.loop(seconds, sync)
    e1.record()
    sync()
    return {"calls": calls, "event_us_per_solve": 1e3 * e0.elapsed_time(e1) / calls}


def run(cell: str, seed: int, on: bool, **kw) -> dict:
    from csr5_bench import harness
    from benchmark_spmv_using_csr5_tpu_torch.utils import trace

    seen = {}
    trace_cls, close, recording = harness.Trace, harness._Solves.close, trace.recording

    def keep(*fields):
        seen["t"] = trace_cls(*fields)
        return seen["t"]

    def timed_close(self):
        seen["untraced"] = untraced_window(self)
        seen["replay_host_us"] = time_replays(self.fn)
        close(self)

    harness.Trace, harness._Solves.close = keep, timed_close
    if not on:
        trace.recording = lambda: False
    try:
        r = harness.run_cell(cell, seed, 25, True, **kw)
    finally:
        harness.Trace, harness._Solves.close, trace.recording = trace_cls, close, recording
    line = {"cell": cell, "seed": seed, "recording": on, "correct": r["correct"],
            "calls": r["attempted"], "window_s": r["device"]["window_s"],
            "card": r["device"].get("nvidia_smi"),
            "metrics": {k: v["value"] for k, v in r["metrics"].items()},
            "replay_host_us_no_profiler": seen.get("replay_host_us")}
    line.update(window_facts(seen["t"]))
    untraced = seen.get("untraced")
    if untraced and line.get("busy_us_per_solve"):
        untraced["idle_pct"] = 100 * (1 - line["busy_us_per_solve"] / untraced["event_us_per_solve"])
        line["untraced"] = untraced
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", default=",".join(CELLS))
    ap.add_argument("--turns", default="on,off,off,on")
    ap.add_argument("--seed", type=int, default=3_141_592_653)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "trace_ab.jsonl"))
    ap.add_argument("--one", nargs=3, metavar=("CELL", "SEED", "TURN"),
                    help="run one window in this process and print its line")
    args = ap.parse_args(argv)
    if args.one:
        cell, seed, turn = args.one
        print(json.dumps(run(cell, int(seed), turn == "on")), flush=True)
        return 0
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    with out.open("a") as f:
        for cell in args.cells.split(","):
            for k, turn in enumerate(args.turns.split(",")):
                # one process per window, as the benchmark runs: a process's
                # later profiler sessions lose device events at their start
                p = subprocess.run([sys.executable, __file__, "--one", cell, str(args.seed + k), turn],
                                   capture_output=True, text=True, cwd=ROOT)
                line = p.stdout.strip().splitlines()[-1] if p.returncode == 0 else json.dumps(
                    {"cell": cell, "turn": turn, "rc": p.returncode, "err": p.stderr[-2000:]})
                print(line, flush=True)
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
