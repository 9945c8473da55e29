#!/usr/bin/env python3
"""Serving tokens/s, TTFT and step time of one or more checkouts of the
port, in turns on one card.

    python3 -m tensorflowonspark_tpu_torch.profile_serving \
        [--variant NAME=DIR ...] [--reps 3] [--rounds 1]

Each variant is a directory holding a ``tensorflowonspark_tpu_torch``
package (default: this checkout, as ``change``). Every variant runs in
its own process, in the order given and then again reversed (A, B, B,
A; ``--rounds`` times), and serves ``chip_smoke.py`` phase 4's leg:
the GPT-2-small-shaped ``DecoderLM`` (vocab 50257, 768, 12 x 64, 12
layers, 1024 positions, random weights from the seed), 16 ``:generate``
requests of 32-512 prompt tokens (4 sharing a 256-token prefix) and
32-128 new tokens from 4 concurrent HTTP clients, a fresh 8-slot paged
engine a pass. The first pass of a process (kernel build, allocator
warm-up) is discarded; each of ``--reps`` passes prints tokens/s
(client wall), the TTFT and decode-step p50 (the engine's histograms)
and the card; the summary adds the engine's stage timers per decode
step. Only public API that every slice of the port has is used, so an
older checkout (``git archive`` of a parent commit) runs as it is.

    python3 -m tensorflowonspark_tpu_torch.profile_serving \
        --layouts engine,pair,pair-concurrent,pair-streams,fleet [--reps 2]

serves the same leg through several engine layouts of this checkout in
turns in ONE process (each layout, then the list reversed, ``--reps``
times, after one discarded pass of the first layout): ``engine`` — one
engine behind one ``ModelServer``; ``pair`` — two engines behind two
servers, clients 0 and 2 on the first, 1 and 3 on the second (a
two-replica fleet's load without its router), taking turns to launch
as engines of one process on one card do (``serving._launch_turn``);
``pair-concurrent`` — the pair launching at once (no turns);
``pair-streams`` — the pair launching at once, each scheduler on a CUDA
stream of its own; ``fleet`` — ``fleet.ServingFleet(replicas=2)``, the
clients on its router. Each pass prints tokens/s,
the decode steps summed over its engines, their decode-step p50, and
per decode step the scheduler threads' CPU ms and voluntary context
switches (``/proc/self/task/<tid>``). Needs one card.
"""

import argparse
import contextlib
import http.client
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

VOCAB, HIDDEN, HEADS, LAYERS, MAX_LEN = 50257, 768, 12, 12, 1024
SLOTS, BLOCK, SEED = 8, 16, 1234


def traffic():
    """``chip_smoke.py``'s phase 4 requests (same seed, same draws)."""
    rng = np.random.RandomState(SEED + 2)
    shared = rng.randint(0, VOCAB, size=256).tolist()
    reqs = []
    for i in range(16):
        n_new = int(rng.randint(32, 129))
        if i % 4 == 1:
            prompt = shared + rng.randint(
                0, VOCAB, size=int(rng.randint(1, 257))).tolist()
        else:
            prompt = rng.randint(0, VOCAB,
                                 size=int(rng.randint(32, 513))).tolist()
        reqs.append((prompt, n_new))
    return reqs


def _clients(ports, reqs, clients=4):
    """Client ``c`` sends requests ``c, c + clients, ...`` to
    ``ports[c % len(ports)]``; returns the wall seconds."""
    errors = []

    def client(c):
        try:
            conn = http.client.HTTPConnection(
                "127.0.0.1", ports[c % len(ports)], timeout=600)
            for i in range(c, len(reqs), clients):
                prompt, n_new = reqs[i]
                conn.request("POST", "/v1/models/gpt2:generate",
                             body=json.dumps({"prompt": prompt,
                                              "max_new_tokens": n_new}))
                resp = conn.getresponse()
                resp.read()
                if resp.status != 200:
                    errors.append(resp.status)
            conn.close()
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(repr(e))

    t0 = time.monotonic()
    threads = []
    for c in range(clients):
        t = threading.Thread(target=client, args=(c,), daemon=True,
                             name="tfos-profile-client-{}".format(c))
        t.start()
        threads.append(t)
    for t in threads:
        t.join()
    wall = time.monotonic() - t0
    if errors:
        raise RuntimeError("clients failed: {}".format(errors))
    return wall


def worker(root, reps):
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from tensorflowonspark_tpu_torch import device_info, serving
    from tensorflowonspark_tpu_torch.models.decoder import DecoderLM

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = device_info.default_device()
    model = DecoderLM(VOCAB, hidden=HIDDEN, num_heads=HEADS,
                      num_layers=LAYERS, max_len=MAX_LEN, device=dev)
    model.init_weights(torch.Generator(device=dev).manual_seed(SEED))
    reqs = traffic()
    tokens = sum(n for _, n in reqs)
    out = []
    for rep in range(reps + 1):
        engine = serving.DecodeEngine(model, slots=SLOTS, total_len=MAX_LEN,
                                      kv_block_size=BLOCK, device=dev)
        with engine:
            with serving.ModelServer(None, name="gpt2", port=0,
                                     engine=engine) as srv:
                wall = _clients([srv.address[1]], reqs)
            ttft = engine.histograms["ttft"].quantile(0.5)
            step = engine.histograms["decode_step"].quantile(0.5)
            stages = engine.timers.snapshot()
            steps = engine.counters.get("decode_steps")
        if rep:  # the first pass builds and warms
            out.append({"tokens_per_s": tokens / wall, "wall_s": wall,
                        "ttft_p50_s": ttft, "step_p50_s": step,
                        "decode_steps": steps, "stages_s": stages})
    print(json.dumps({"root": root, "card": device_info.describe()
                      .splitlines()[0], "passes": out}), flush=True)
    return 0


def _sched_stats(engine):
    """(CPU seconds, voluntary context switches or None where the
    kernel does not count them) of ``engine``'s scheduler thread so
    far, from ``/proc/self/task/<tid>``."""
    task = "/proc/self/task/{}/".format(engine._thread.native_id)
    with open(task + "stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    cpu = (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")
    with open(task + "status") as f:
        switches = next((int(line.split()[1]) for line in f
                         if line.startswith("voluntary_ctxt_switches")),
                        None)
    return cpu, switches


def _layout_pass(layout, model, reqs, dev):
    """One pass of ``layout`` (see the module docstring); returns (wall
    s, engines, [scheduler stats a engine])."""
    import torch

    from tensorflowonspark_tpu_torch import fleet, serving

    kw = {"slots": SLOTS, "total_len": MAX_LEN, "kv_block_size": BLOCK,
          "device": dev}
    if layout == "fleet":
        with fleet.ServingFleet(model, replicas=2, name="gpt2",
                                engine_kw=kw) as f:
            wall = _clients([f.router_addr[1]], reqs)
            engines = [r.engine for r in f.replicas]
            return wall, engines, [_sched_stats(e) for e in engines]

    class OwnStreamEngine(serving.DecodeEngine):
        def _run(self):
            stream = torch.cuda.Stream(self.device)
            stream.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(stream):
                super()._run()

    cls = OwnStreamEngine if layout == "pair-streams" \
        else serving.DecodeEngine
    turn = serving._launch_turn
    if layout in ("pair-concurrent", "pair-streams"):
        serving._launch_turn = lambda device: contextlib.nullcontext()
    engines, servers = [], []
    try:
        for _ in range(1 if layout == "engine" else 2):
            engines.append(cls(model, **kw))
            servers.append(serving.ModelServer(None, name="gpt2", port=0,
                                               engine=engines[-1]))
        wall = _clients([srv.start()[1] for srv in servers], reqs)
        stats = [_sched_stats(e) for e in engines]
    finally:
        serving._launch_turn = turn
        for srv in servers:
            srv.stop()
        for e in engines:
            e.stop()
    return wall, engines, stats


def layouts(names, reps):
    """Serve the leg through each layout of ``names`` in turns in this
    process; prints a line a pass, a median line a layout and the JSON
    of every pass."""
    import torch

    from tensorflowonspark_tpu_torch import device_info
    from tensorflowonspark_tpu_torch.models.decoder import DecoderLM

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = device_info.default_device()
    card = device_info.describe().splitlines()[0]
    model = DecoderLM(VOCAB, hidden=HIDDEN, num_heads=HEADS,
                      num_layers=LAYERS, max_len=MAX_LEN, device=dev)
    model.init_weights(torch.Generator(device=dev).manual_seed(SEED))
    reqs = traffic()
    tokens = sum(n for _, n in reqs)
    _layout_pass(names[0], model, reqs, dev)  # build and warm
    results = {name: [] for name in names}
    for _ in range(reps):
        for name in names + names[::-1]:
            wall, engines, stats = _layout_pass(name, model, reqs, dev)
            steps = sum(e.counters.get("decode_steps") for e in engines)
            row = {"tokens_per_s": tokens / wall, "wall_s": wall,
                   "decode_steps": steps,
                   "step_p50_s": float(np.median(
                       [e.histograms["decode_step"].quantile(0.5)
                        for e in engines])),
                   "sched_cpu_ms_per_step":
                       sum(c for c, _ in stats) / steps * 1e3,
                   "sched_switches_per_step": None if any(
                       v is None for _, v in stats)
                       else sum(v for _, v in stats) / steps}
            results[name].append(row)
            print("{} {:<12} {:.1f} tokens/s, {} decode steps, step p50 "
                  "{:.4f} s, scheduler CPU {:.3f} ms and {} voluntary "
                  "switches a step".format(
                      card, name, row["tokens_per_s"], steps,
                      row["step_p50_s"], row["sched_cpu_ms_per_step"],
                      row["sched_switches_per_step"]), flush=True)
    for name, rows in results.items():
        med = {k: None if any(r[k] is None for r in rows)
               else float(np.median([r[k] for r in rows]))
               for k in rows[0]}
        print("{:<12} median tokens/s {:.1f} (min {:.1f}, max {:.1f}); "
              "decode steps {:.0f}; step p50 {:.4f} s; scheduler CPU "
              "{:.3f} ms, {} voluntary switches a step".format(
                  name, med["tokens_per_s"],
                  min(r["tokens_per_s"] for r in rows),
                  max(r["tokens_per_s"] for r in rows),
                  med["decode_steps"], med["step_p50_s"],
                  med["sched_cpu_ms_per_step"],
                  med["sched_switches_per_step"]))
    print(json.dumps({"card": card, "layouts": results}))
    return 0


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variant", action="append", default=[],
                    metavar="NAME=DIR")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--rounds", type=int, default=1,
                    help="repeat the A, B, B, A order this many times")
    ap.add_argument("--layouts", default=None,
                    help="comma-separated layouts of this checkout to "
                         "serve in turns in one process (engine, pair, "
                         "pair-concurrent, pair-streams, fleet)")
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker is not None:
        return worker(args.worker, args.reps)
    if args.layouts is not None:
        names = args.layouts.split(",")
        bad = set(names) - {"engine", "pair", "pair-concurrent",
                            "pair-streams", "fleet"}
        if bad:
            ap.error("unknown layouts {}".format(sorted(bad)))
        return layouts(names, args.reps)
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    variants = [v.split("=", 1) for v in args.variant] or [["change", here]]
    order = (variants + variants[::-1]) * max(1, args.rounds)
    results = {name: [] for name, _ in variants}
    for name, root in order:
        cmd = [sys.executable, os.path.abspath(__file__), "--worker", root,
               "--reps", str(args.reps)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        got = json.loads(proc.stdout.strip().splitlines()[-1])
        results[name] += got["passes"]
        print("{:<8} {}  ".format(name, got["card"]) + "  ".join(
            "{:.1f} tok/s ttft {:.4f}s step {:.4f}s".format(
                p["tokens_per_s"], p["ttft_p50_s"], p["step_p50_s"])
            for p in got["passes"]), flush=True)
    for name, passes in results.items():
        stage_ms = {k: np.median([p["stages_s"].get(k, 0.0)
                                  / p["decode_steps"] * 1e3
                                  for p in passes])
                    for k in passes[0]["stages_s"]}
        print("{:<8} median tokens/s {:.1f} (min {:.1f}, max {:.1f}); "
              "TTFT p50 median {:.4f}s; step p50 median {:.4f}s; stage ms "
              "a decode step: {}".format(
                  name, np.median([p["tokens_per_s"] for p in passes]),
                  min(p["tokens_per_s"] for p in passes),
                  max(p["tokens_per_s"] for p in passes),
                  np.median([p["ttft_p50_s"] for p in passes]),
                  np.median([p["step_p50_s"] for p in passes]),
                  ", ".join("{} {:.4f}".format(k, v)
                            for k, v in sorted(stage_ms.items()))))
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
