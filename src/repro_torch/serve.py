"""Serve a model with batched requests: prefill + greedy decode through
the cached serve path (KV caches, the RG-LRU and xLSTM layers' recurrent
state, an encoder-decoder's encoder states, a VLM's prefix). The twin of
the JAX package's ``examples/serve.py``.

    python -m repro_torch.serve --arch llama-65b --layers 10 --batch 4 \\
        --prompt-len 2048 --gen 16                # full width, on the card
    python -m repro_torch.serve --arch whisper-small --reduced --device cpu

Weights are random (fp32, cast to the config's compute dtype on read) and
drawn, with the prompts, from seed 0; a VLM's prefix embeddings
(``num_prefix_embeds`` of them) from seed 2 and an encoder-decoder's frame
embeddings (``ENCODER_FRAMES``, 16 with ``--reduced`` as in the twin) from
seed 3. Without ``--device cpu`` it runs on the card and raises when there
is none.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.models import model as M
from repro_torch.train.steps import make_serve_step


def config_for(arch, *, layers=None, attn_impl="flash", reduced=False):
    """The arch's config at full width (or its fp32 smoke-scale variant),
    with its depth cut to ``layers`` and the given attention arm."""
    cfg = get_config(arch)
    if reduced:
        cfg = dataclasses.replace(cfg.reduced(), dtype="float32")
    kw = {"attn_impl": attn_impl}
    if layers:
        kw["num_layers"] = layers
    return dataclasses.replace(cfg, **kw)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.inference_mode()
def serve(params, cfg, prompts, gen: int, *, prefix_embeds=None,
          enc_embeds=None):
    """Prefill ``prompts`` (b, sp), after a VLM's ``prefix_embeds`` (b, n,
    d) and over an encoder-decoder's ``enc_embeds`` (b, frames, d), and
    greedily decode until each sequence has ``gen`` new tokens. Returns the
    tokens (b, gen), the logits of the prefill and of the last step, and
    host-clock times that end in a device synchronise."""
    b, sp = prompts.shape
    device = prompts.device
    batch = {"tokens": prompts}
    npre = 0
    if prefix_embeds is not None and cfg.frontend == "vision":
        batch["prefix_embeds"] = prefix_embeds
        npre = prefix_embeds.shape[1]
    if cfg.is_encdec:
        batch["enc_embeds"] = enc_embeds
    state = M.init_decode_state(cfg, b, sp + gen + npre, device)
    serve_step = make_serve_step(cfg)
    _sync(device)
    t0 = time.perf_counter()
    prefill_logits, state, enc = M.prefill(params, batch, cfg, state)
    tok = torch.argmax(prefill_logits, dim=-1).to(torch.int32)
    _sync(device)
    t1 = time.perf_counter()
    out, logits = [tok], prefill_logits
    for i in range(gen - 1):
        tok, logits, state = serve_step(params, state, tok, sp + npre + i, enc)
        out.append(tok)
    _sync(device)
    t2 = time.perf_counter()
    return {
        "tokens": torch.stack(out, 1),
        "prefill_logits": prefill_logits,
        "last_logits": logits,
        "prefill_s": t1 - t0,
        "decode_s": t2 - t1,
        "decode_tok_s": (gen - 1) * b / (t2 - t1) if gen > 1 else 0.0,
    }


def frontend_inputs(cfg, batch: int, device, *, frames: int):
    """A VLM's prefix embeddings (seed 2) and an encoder-decoder's
    ``frames`` frame embeddings (seed 3), standard normal, as keyword
    arguments of ``serve``."""
    kw = {}
    if cfg.frontend == "vision" and cfg.num_prefix_embeds:
        kw["prefix_embeds"] = torch.randn(
            (batch, cfg.num_prefix_embeds, cfg.d_model),
            generator=torch.Generator(device).manual_seed(2), device=device)
    if cfg.is_encdec:
        kw["enc_embeds"] = torch.randn(
            (batch, frames, cfg.d_model),
            generator=torch.Generator(device).manual_seed(3), device=device)
    return kw


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="llama-65b")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers")
    ap.add_argument("--reduced", action="store_true",
                    help="the arch's fp32 smoke-scale variant")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--attn-impl", default="flash",
                    choices=("flash", "reference"))
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = config_for(args.arch, layers=args.layers, attn_impl=args.attn_impl,
                     reduced=args.reduced)
    gen = torch.Generator(device).manual_seed(0)
    params = M.init_params(gen, cfg, device)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen, device=device)
    res = serve(params, cfg, prompts, args.gen, **frontend_inputs(
        cfg, args.batch, device,
        frames=16 if args.reduced else M.ENCODER_FRAMES))
    b, sp = prompts.shape
    print(f"[prefill] {b} x {sp} tokens in {res['prefill_s']:.4f} s")
    print(f"[decode] {args.gen - 1} steps x {b} seqs in {res['decode_s']:.4f} s "
          f"({res['decode_tok_s']:.1f} tok/s)")
    for r in range(min(b, 2)):
        print(f"  seq{r}: {res['tokens'][r, :12].tolist()}...")
    return res


if __name__ == "__main__":
    main()
