"""Closed loop of generation calls: one client sends one
``repro_torch.serve.generate`` call of ``batch`` sequences at a time and
sends the next as soon as one returns (its ids on the host).

Mix keys: ``batch`` (sequences a call, each one request), ``prompt_len``
(token ids a prompt), ``new_tokens`` (tokens a request generates: its
``n``).  Every prompt is new: ``batch`` x ``prompt_len`` ids drawn on the
program's device, uniform over the configuration's ``vocab_size`` real
ids, from a generator seeded from the run's seed; the sampler's generator
and the choice of each call's kept row come from the seed too.  Each call
keeps the logits of one row (``keep_rows``), which the program's check
holds to its reference.  The warm-up starts the program from the seed
(its weights) and makes one call at the window's shapes, from a stream of
prompts the window never sends.
"""

from __future__ import annotations

import numpy as np

from .records import Req


def _stream(seed: int, k: int) -> int:
    """A generator seed for stream ``k`` of the run's ``seed``."""
    word = np.random.SeedSequence([int(seed) % 2**64, 7, k]) \
        .generate_state(1, np.uint64)[0]
    return int(word) % 2**63


def prepare(mix: dict, config: dict, seed: int, seconds: float) -> dict:
    """The run's settings from ``seed``; nothing runs yet."""
    return {"seed": int(seed), "batch": int(mix["batch"]),
            "prompt_len": int(mix["prompt_len"]),
            "new_tokens": int(mix["new_tokens"]),
            "vocab": int(config["vocab_size"]),
            "rows": np.random.default_rng(_stream(seed, 0))}


def _prompts(plan: dict, gen, device):
    import torch
    return torch.randint(0, plan["vocab"], (plan["batch"],
                                            plan["prompt_len"]),
                         generator=gen, device=device)


def _generator(plan: dict, k: int, device):
    import torch
    return torch.Generator(device=device).manual_seed(_stream(plan["seed"],
                                                              k))


def warm(plan: dict, server, hooks) -> None:
    """The program's model from the seed, then one call at the window's
    shapes on prompts the window never sends."""
    server.start(plan["seed"])
    dev = server.device
    prompts = _prompts(plan, _generator(plan, 1, dev), dev)
    ids, _ = server.generate(prompts, plan["new_tokens"],
                             _generator(plan, 2, dev), [0])
    ids.cpu()
    hooks.synchronize()


def drive(plan: dict, server, seconds: float, hooks) -> dict:
    """The measured window.  A response's time is the return of its call,
    once its ids are on the host."""
    clock = hooks.clock
    dev = server.device
    gen_prompts = _generator(plan, 3, dev)
    gen_sample = _generator(plan, 4, dev)
    b, n_new = plan["batch"], plan["new_tokens"]
    t_submit, t_done, answers, kept = [], [], [], []
    error = None
    hooks.opened()
    t0 = clock()
    end = t0 + seconds
    client = 0.0
    t = t0
    try:
        with hooks.span("window"):
            while clock() < end:
                prompts = _prompts(plan, gen_prompts, dev)
                row = int(plan["rows"].integers(b))
                ts = clock()
                client += ts - t
                with hooks.span("feed"):
                    ids, logits = server.generate(prompts, n_new, gen_sample,
                                                  [row])
                    host = ids.cpu().numpy()
                t = clock()
                t_submit += [ts] * b
                t_done += [t] * b
                answers += list(host)
                kept.append({"prompt": prompts[row], "ids": ids[row],
                             "logits": logits[0]})
    except Exception as exc:                 # judged by the harness
        error = exc
    t_loop = clock()
    hooks.closed()
    for k in kept:
        for key in k:
            k[key] = k[key].cpu()
    requests = [Req("generate", None, None, n_new, i)
                for i in range(len(answers))]
    return {
        "requests": requests,
        "responses": answers,
        "kept": kept,
        "new_tokens": n_new,
        "t_due": np.asarray(t_submit),
        "t_submit": np.asarray(t_submit),
        "t_done": np.asarray(t_done),
        "errors": [None] * len(answers),
        "t0": t0,
        "t_end": end,
        "t_loop": t_loop,
        "client_s": client,
        "error": error,
    }
