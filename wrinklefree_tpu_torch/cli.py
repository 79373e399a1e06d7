"""Command-line interface (PyTorch port of ``wrinklefree_tpu/cli.py``).

``serve``, ``generate``, ``chat``, ``convert``, ``convert-gguf``,
``validate-model``, ``validate`` (the KV-cache validator, ``kv/validator.py``),
``list-models``, ``benchmark`` and ``benchmark-cost`` as the reference's;
``serve`` starts the port's server (``--tiny --device cpu`` off the card; on
it ``--model synth:bitnet_2b``, a model directory or a ``.gguf``); with
``--tp N`` under ``torchrun --nproc-per-node N`` it serves tensor-parallel
(rank 0 answers HTTP, the other ranks follow it), with ``--dp M`` as well
under ``torchrun --nproc-per-node N*M`` M such replicas, and with
``--long-context`` prompts of ``max_context`` tokens or more through ring
attention.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def cmd_serve(args):
    from .server.http import main as server_main

    argv = []
    if args.tiny:
        argv.append("--tiny")
    if args.model:
        argv += ["--model", args.model]
    argv += ["--host", args.host, "--port", str(args.port)]
    if args.kv_dtype:
        argv += ["--kv-dtype", args.kv_dtype]
    for flag in ("kv_layout", "exact_head", "window", "global_tokens", "tp", "dp"):
        if getattr(args, flag):
            argv += ["--" + flag.replace("_", "-"), str(getattr(args, flag))]
    if args.long_context:
        argv.append("--long-context")
    if args.tokenizer:
        argv += ["--tokenizer", args.tokenizer]
    if args.device:
        argv += ["--device", args.device]
    server_main(argv)


def cmd_generate(args):
    from .client import InferenceClient

    c = InferenceClient(args.url)
    if not c.health():
        print(f"no server at {args.url}", file=sys.stderr)
        sys.exit(1)
    t0 = time.perf_counter()
    n = 0
    for chunk in c.generate_stream(args.prompt, max_tokens=args.max_tokens,
                                   temperature=args.temperature):
        print(chunk, end="", flush=True)
        n += 1
    dt = time.perf_counter() - t0
    print(f"\n[{n} chunks in {dt:.2f}s]", file=sys.stderr)


def cmd_chat(args):
    from .client import InferenceClient

    c = InferenceClient(args.url)
    if not c.health():
        print(f"no server at {args.url}", file=sys.stderr)
        sys.exit(1)
    messages = []
    print("wrinklefree chat (ctrl-d to exit)")
    while True:
        try:
            user = input("you> ")
        except EOFError:
            break
        if not user.strip():
            continue
        messages.append({"role": "user", "content": user})
        print("bot> ", end="", flush=True)
        parts = []
        for chunk in c.chat_stream(messages, max_tokens=args.max_tokens,
                                   temperature=args.temperature):
            print(chunk, end="", flush=True)
            parts.append(chunk)
        print()
        messages.append({"role": "assistant", "content": "".join(parts)})


def cmd_convert(args):
    from .convert.convert import convert_and_save

    out = convert_and_save(args.model, args.output, revision=args.revision,
                           ternarize=getattr(args, "ternarize", False))
    print(f"converted -> {out}")


def cmd_convert_gguf(args):
    from .convert.gguf import convert_hf_to_gguf, validate_gguf

    out = convert_hf_to_gguf(args.model, args.output, quant_type=args.quant_type)
    info = validate_gguf(out)
    print(f"wrote {out} ({info['n_tensors']} tensors, {info['size_bytes']} bytes)")


def cmd_validate_model(args):
    from .convert.validate import validate_model

    rep = validate_model(args.model)
    print(json.dumps(rep, indent=2))
    sys.exit(0 if rep["valid"] else 1)


def cmd_list_models(args):
    from .convert.loader import list_cached_models

    for m in list_cached_models():
        print(m)


def cmd_validate(args):
    from .kv.validator import run_kv_cache_validation

    ok = run_kv_cache_validation(args.url)
    sys.exit(0 if ok else 1)


def cmd_benchmark(args):
    from .bench.runner import run_server_benchmark

    result = run_server_benchmark(args.url, num_requests=args.num_requests,
                                  max_tokens=args.max_tokens, concurrency=args.concurrency)
    print(json.dumps(result, indent=2))


def cmd_benchmark_cost(args):
    from .bench.cost import CostTracker

    tracker = CostTracker(hourly_cost=args.hourly_cost)
    print(json.dumps(tracker.report(tokens_per_second=args.toks), indent=2))


def main(argv=None):
    p = argparse.ArgumentParser("wrinklefree-tpu-torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("serve", help="start the inference server")
    s.add_argument("--model", help="a model directory, a .gguf file, or "
                   "synth:<BitNetConfig classmethod>, e.g. synth:bitnet_2b")
    s.add_argument("--tiny", action="store_true")
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=30000)
    s.add_argument("--kv-dtype", default=None)
    s.add_argument("--kv-layout", default=None, choices=["auto", "layer", "token"])
    s.add_argument("--exact-head", type=int, default=0, metavar="K",
                   help="exact greedy head with a top-K shortlist (0: the bf16 head)")
    s.add_argument("--window", type=int, default=0, help="sliding-window attention width")
    s.add_argument("--global-tokens", type=int, default=0)
    s.add_argument("--tokenizer", default=None,
                   help="tokenizer.json dir (default: the model dir)")
    s.add_argument("--device", default=None, help="torch device (default: cuda)")
    s.add_argument("--tp", type=int, default=0,
                   help="tensor-parallel ranks (run under torchrun --nproc-per-node N)")
    s.add_argument("--dp", type=int, default=0,
                   help="replicas (with --tp N: under torchrun --nproc-per-node N*M)")
    s.add_argument("--long-context", action="store_true",
                   help="serve prompts of max_context tokens or more through ring attention")
    s.set_defaults(fn=cmd_serve)

    s = sub.add_parser("generate", help="generate from a live server")
    s.add_argument("prompt")
    s.add_argument("--url", default="http://127.0.0.1:30000")
    s.add_argument("--max-tokens", type=int, default=128)
    s.add_argument("--temperature", type=float, default=0.7)
    s.set_defaults(fn=cmd_generate)

    s = sub.add_parser("chat", help="interactive chat against a live server")
    s.add_argument("--url", default="http://127.0.0.1:30000")
    s.add_argument("--max-tokens", type=int, default=256)
    s.add_argument("--temperature", type=float, default=0.7)
    s.set_defaults(fn=cmd_chat)

    s = sub.add_parser("convert-gguf", help="export HF/packed model to GGUF")
    s.add_argument("model")
    s.add_argument("output")
    s.add_argument("--quant-type", default="i2_s",
                   choices=["i2_s", "tl1", "tl2", "f16", "f32"])
    s.set_defaults(fn=cmd_convert_gguf)

    s = sub.add_parser("convert", help="convert HF model to packed cache")
    s.add_argument("model")
    s.add_argument("output")
    s.add_argument("--revision", default=None)
    s.add_argument("--ternarize", action="store_true",
                   help="naive FP16->ternary conversion of a dense model")
    s.set_defaults(fn=cmd_convert)

    s = sub.add_parser("validate-model", help="validate a ternary model directory")
    s.add_argument("model")
    s.set_defaults(fn=cmd_validate_model)

    s = sub.add_parser("validate", help="black-box KV-cache validation of a server")
    s.add_argument("--url", default="http://127.0.0.1:30000")
    s.set_defaults(fn=cmd_validate)

    s = sub.add_parser("list-models", help="list locally cached converted models")
    s.set_defaults(fn=cmd_list_models)

    s = sub.add_parser("benchmark", help="benchmark a live server")
    s.add_argument("--url", default="http://127.0.0.1:30000")
    s.add_argument("--num-requests", type=int, default=8)
    s.add_argument("--max-tokens", type=int, default=64)
    s.add_argument("--concurrency", type=int, default=1)
    s.set_defaults(fn=cmd_benchmark)

    s = sub.add_parser("benchmark-cost", help="cost per 1M tokens")
    s.add_argument("--toks", type=float, required=True, help="tokens/sec")
    s.add_argument("--hourly-cost", type=float, default=1.2, help="$/hr")
    s.set_defaults(fn=cmd_benchmark_cost)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
