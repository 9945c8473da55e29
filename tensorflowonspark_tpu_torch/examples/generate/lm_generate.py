"""Train a small decoder LM, then continue prompts with the KV cache —
the port of ``examples/generate/lm_generate.py``.

A decoder-only LM trains on synthetic periodic sequences (a plain Adam
loop), then ``generation.generate_jit`` continues a prompt over the
contiguous cache, greedy or top-k sampled. ``--serve N`` also pushes N
mixed-length prompts through the continuous-batching engine
(``serving.DecodeEngine``, paged KV) and checks every output
token-identical to a solo ``generate`` call; ``--tenant`` /
``--priority`` tag those requests with a QoS identity (the engine's
per-tenant token tally is reported as ``tenant_tokens``).

    python -m tensorflowonspark_tpu_torch.examples.generate.lm_generate \\
        --steps 150 --serve 8 [--tenant a --priority high] [--device cpu]

Runs on the card unless ``--device cpu`` is given. ``--fleet`` and
``--executors`` wait for the port's fleet plane (ROADMAP.md Queue 1
item 9) and raise.
"""

import argparse
import json
import os
import time

from tensorflowonspark_tpu_torch.examples import _common


def _not_ported(args):
    waits = (("fleet", "the serving fleet (ROADMAP Queue 1 item 9)"),
             ("executors", "the serving fleet's executor placement "
                           "(ROADMAP Queue 1 item 9)"))
    for flag, what in waits:
        if getattr(args, flag):
            raise SystemExit(
                "--{} is not ported yet: it needs {}".format(flag, what))


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
                    help="not ported yet (ROADMAP Queue 1 item 9)")
    ap.add_argument("--executors", type=int, default=0, metavar="N",
                    help="not ported yet (ROADMAP Queue 1 item 9)")
    ap.add_argument("--tenant", default=None,
                    help="tenant id attached to every --serve request; "
                         "omitted: the engine's default tenant")
    ap.add_argument("--priority", default=None,
                    choices=["high", "normal", "low"],
                    help="priority class for the --serve requests "
                         "(default: normal)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="write {loss, prompt, generated, serve} JSON here")
    _common.add_device_flag(ap)
    args = ap.parse_args(argv)
    _not_ported(args)

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
    result = {"device": str(dev), "loss_first": losses[0] if losses else None,
              "loss": losses[-1] if losses else None, "prompt": prompt[0],
              "generated": generated, "serve": serve_stats}
    print(json.dumps(result), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f)
    if serve_stats is not None and serve_stats["solo_mismatches"]:
        raise SystemExit(
            "continuous-batching outputs diverged from solo generate")
    return result


if __name__ == "__main__":
    main()
