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
Needs one card.
"""

import argparse
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


def _serve_pass(serving, engine, reqs, clients=4):
    errors = []
    with serving.ModelServer(None, name="gpt2", port=0,
                             engine=engine) as srv:
        port = srv.address[1]

        def client(c):
            try:
                conn = http.client.HTTPConnection("127.0.0.1", port,
                                                  timeout=600)
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
            wall = _serve_pass(serving, engine, reqs)
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variant", action="append", default=[],
                    metavar="NAME=DIR")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--rounds", type=int, default=1,
                    help="repeat the A, B, B, A order this many times")
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker is not None:
        return worker(args.worker, args.reps)
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
