"""Train a small decoder LM, then continue prompts with the KV cache —
the port of ``examples/generate/lm_generate.py``.

A decoder-only LM trains on synthetic periodic sequences (a plain Adam
loop), then ``generation.generate_jit`` continues a prompt over the
contiguous cache, greedy or top-k sampled. ``--serve N`` also pushes N
mixed-length prompts through the continuous-batching engine
(``serving.DecodeEngine``, paged KV) and checks every output
token-identical to a solo ``generate`` call; ``--tenant`` /
``--priority`` tag those requests with a QoS identity (the engine's
per-tenant token tally is reported as ``tenant_tokens``). ``--fleet R``
also serves prompts over HTTP through an R-replica serving fleet
(``cluster.serving_fleet``: replicas behind the router, with the shared
``serving.retry_call`` client retry policy) and checks every output
against solo ``generate``; with ``--executors N`` the replicas run
inside N engine executor processes, each building the model on its
own device.

    python -m tensorflowonspark_tpu_torch.examples.generate.lm_generate \\
        --steps 150 --serve 8 [--fleet 2 [--executors 2]] \\
        [--tenant a --priority high] [--device cpu]

Runs on the card unless ``--device cpu`` is given.
"""

import argparse
import json
import os
import time

from tensorflowonspark_tpu_torch.examples import _common


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--vocab", type=int, default=8)
    ap.add_argument("--period", type=int, default=4)
    ap.add_argument("--seq_len", type=int, default=24)
    ap.add_argument("--hidden", type=int, default=32)
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--max_new", type=int, default=8)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top_k", type=int, default=None)
    ap.add_argument("--serve", type=int, default=0, metavar="N",
                    help="also serve N mixed-length prompts through the "
                         "continuous-batching DecodeEngine and report "
                         "tokens/s and solo parity")
    ap.add_argument("--fleet", type=int, default=0, metavar="R",
                    help="also serve the prompts over HTTP through an "
                         "R-replica serving fleet (the fleet router), "
                         "with the shared serving.retry_call client "
                         "retry policy, and report solo parity")
    ap.add_argument("--executors", type=int, default=0, metavar="N",
                    help="with --fleet: host the replicas INSIDE N "
                         "engine executor processes instead of this "
                         "one; each replica's executor and pid are "
                         "printed")
    ap.add_argument("--tenant", default=None,
                    help="tenant id attached to every --serve/--fleet "
                         "request; "
                         "omitted: the engine's default tenant")
    ap.add_argument("--priority", default=None,
                    choices=["high", "normal", "low"],
                    help="priority class for the --serve/--fleet "
                         "requests "
                         "(default: normal)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="write {loss, prompt, generated, serve} JSON here")
    _common.add_device_flag(ap)
    args = ap.parse_args(argv)
    if args.executors and args.executors < args.fleet:
        raise SystemExit(
            "--executors {} < --fleet {}: each replica needs its own "
            "executor".format(args.executors, args.fleet))

    import numpy as np
    import torch
    import torch.nn.functional as F

    from tensorflowonspark_tpu_torch import device_info, generation, serving
    from tensorflowonspark_tpu_torch.models.decoder import DecoderLM

    dev = device_info.default_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    gen = _common.generator(dev, args.seed)
    max_len = args.seq_len * 2
    model = DecoderLM(args.vocab, hidden=args.hidden, num_heads=4,
                      num_layers=2, max_len=max_len, device=dev)
    model.init_weights(gen)
    rng = np.random.RandomState(args.seed)

    def batch():
        starts = rng.randint(0, args.period, size=(args.batch_size, 1))
        seq = (starts + np.arange(args.seq_len + 1)) % args.period
        return torch.as_tensor(seq, dtype=torch.long, device=dev)

    opt = torch.optim.Adam(model.parameters(), lr=args.lr)
    losses = []
    model.train()
    for i in range(args.steps):
        toks = batch()
        logits = model(toks[:, :-1])
        loss = F.cross_entropy(logits.reshape(-1, args.vocab),
                               toks[:, 1:].reshape(-1))
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(loss.item())
        if i % 50 == 0:
            print("step %d loss %.4f" % (i, losses[-1]), flush=True)
    model.eval()

    prompt = [[i % args.period for i in range(6)]]
    sample_gen = _common.generator(dev, 1) if args.temperature else None
    out = generation.generate_jit(
        model, prompt, args.max_new, temperature=args.temperature,
        generator=sample_gen, top_k=args.top_k, device=dev)
    generated = out[0, len(prompt[0]):].tolist()
    print("prompt   ", prompt[0])
    print("generated", generated)

    serve_stats = None
    if args.serve:
        rs = np.random.RandomState(1)
        reqs = []
        for _ in range(args.serve):
            n = int(rs.randint(3, args.seq_len))
            start = int(rs.randint(0, args.period))
            reqs.append(([(start + i) % args.period for i in range(n)],
                         int(rs.randint(2, args.seq_len))))
        with serving.DecodeEngine(model, slots=4, total_len=max_len,
                                  device=dev) as eng:
            t0 = time.monotonic()
            handles = [eng.submit(p, mn, tenant=args.tenant,
                                  priority=args.priority)
                       for p, mn in reqs]
            outs = [h.result(600) for h in handles]
            wall = time.monotonic() - t0
            tokens = eng.counters.snapshot()["counts"]["tokens"]
            per_step = eng.counters.rate("decode_tokens", "decode_steps")
            tenant_tokens = eng.qos_tallies()["tokens"]
        # the serving path must agree with the offline path, request by
        # request (greedy: token-identical)
        mismatches = sum(
            1 for (p, mn), got in zip(reqs, outs)
            if got != generation.generate_jit(model, [p], mn,
                                              device=dev)[0].tolist())
        serve_stats = {"requests": len(reqs), "tokens": int(tokens),
                       "tokens_per_sec": round(tokens / wall, 1),
                       "tokens_per_step": round(per_step, 2),
                       "tenant_tokens": tenant_tokens,
                       "solo_mismatches": mismatches}
        print("served   ", serve_stats, flush=True)
    fleet_stats = None
    if args.fleet:
        fleet_stats = _fleet(args, model, dev, max_len)
        print("fleet    ", fleet_stats, flush=True)
    result = {"device": str(dev), "loss_first": losses[0] if losses else None,
              "loss": losses[-1] if losses else None, "prompt": prompt[0],
              "generated": generated, "serve": serve_stats,
              "fleet": fleet_stats}
    print(json.dumps(result), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f)
    if serve_stats is not None and serve_stats["solo_mismatches"]:
        raise SystemExit(
            "continuous-batching outputs diverged from solo generate")
    if fleet_stats is not None and fleet_stats["solo_mismatches"]:
        raise SystemExit("fleet-served outputs diverged from solo generate")
    return result


def _fleet(args, model, dev, max_len):
    """Serve mixed-length prompts over HTTP through an ``args.fleet``
    replica fleet (in this process, or in ``args.executors`` executor
    processes) and hold each output against solo ``generate``."""
    import urllib.error
    import urllib.request

    import numpy as np

    from tensorflowonspark_tpu_torch import cluster, generation, serving

    rs = np.random.RandomState(2)
    reqs = []
    for _ in range(max(args.serve, 4)):
        n = int(rs.randint(3, args.seq_len))
        start = int(rs.randint(0, args.period))
        reqs.append(([(start + i) % args.period for i in range(n)],
                     int(rs.randint(2, args.seq_len))))
    sc = None
    fleet_kw = {}
    if args.executors:
        # executor-hosted replicas: each bootstraps inside an executor
        # process, builds the model there from the shipped state dict
        # and registers its real HTTP address over BEAT
        from tensorflowonspark_tpu_torch.engine import Context
        sc = Context(args.executors)
        fleet_kw = dict(placement="executors", sc=sc, spawn_timeout=300)
    placement = None
    try:
        fl = cluster.serving_fleet(
            model, replicas=args.fleet, name="lm",
            engine_kw={"slots": 4, "total_len": max_len,
                       "device": str(dev)}, **fleet_kw)
        try:
            snapshot = fl.reservation.serving_snapshot()
            if args.executors:
                placement = {rid: info.get("host")
                             for rid, info in snapshot.items()}
                print("placement", placement,
                      "(driver pid {})".format(os.getpid()), flush=True)
            devices = sorted({str(info["serving"].get("device"))
                              for info in snapshot.values()})
            url = fl.url("/v1/models/lm:generate")

            def post(payload):
                # the SHARED client retry policy (serving.retry_call):
                # transient 429/503s retry with bounded backoff + full
                # jitter, honoring the router's Retry-After
                def attempt():
                    req = urllib.request.Request(
                        url, data=json.dumps(payload).encode(),
                        headers={"Content-Type": "application/json"})
                    try:
                        with urllib.request.urlopen(req, timeout=300) as r:
                            return json.loads(r.read())
                    except urllib.error.HTTPError as e:
                        retriable = serving.http_retriable(
                            e.code, e.headers.get("Retry-After"))
                        if retriable is not None:
                            raise retriable
                        raise
                return serving.retry_call(attempt)

            qos_fields = {}
            if args.tenant is not None:
                qos_fields["tenant"] = args.tenant
            if args.priority is not None:
                qos_fields["priority"] = args.priority
            t0 = time.monotonic()
            # each request carries a session id: the router pins a
            # conversation's later turns to the replica whose prefix
            # cache is warm for it
            outs = [post(dict({"prompt": p, "max_new_tokens": mn,
                               "session": "demo-{}".format(i)},
                              **qos_fields))["tokens"]
                    for i, (p, mn) in enumerate(reqs)]
            wall = time.monotonic() - t0
            counts = fl.router.counters.snapshot()["counts"]
        finally:
            fl.stop()
    finally:
        if sc is not None:
            sc.stop()
    mismatches = sum(
        1 for (p, mn), got in zip(reqs, outs)
        if got != generation.generate_jit(model, [p], mn,
                                          device=dev)[0].tolist())
    tokens = sum(len(got) - len(p) for (p, _), got in zip(reqs, outs))
    return {"replicas": args.fleet, "executors": args.executors,
            "requests": len(reqs), "tokens": tokens,
            "tokens_per_sec": round(tokens / wall, 1),
            "failovers": counts.get("failovers", 0),
            "affinity_hits": counts.get("affinity_hits", 0),
            "replica_devices": devices, "placement": placement,
            "solo_mismatches": mismatches}


if __name__ == "__main__":
    main()
