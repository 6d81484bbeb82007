"""Serving example on PyTorch: batched prefill + sampled decode with the
KV-cache / SSM-state machinery.

    PYTHONPATH=src python examples/torch_serve_lm.py --arch falcon-mamba-7b
    PYTHONPATH=src python examples/torch_serve_lm.py --arch glm4-9b \\
        --restore checkpoints/train_lm.npz   # serve a ColRel-trained model

The port's copy of ``examples/serve_lm.py``: the ``reduced()`` config of
the architecture.  Runs on the GPU unless ``--device cpu``."""
import argparse
import time

import numpy as np
import torch

from repro_torch import checkpoint
from repro_torch.configs import registry as creg
from repro_torch.models import registry as mreg
from repro_torch.utils import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="glm4-9b", choices=sorted(creg.ASSIGNED))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=24)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--restore", default="")
    ap.add_argument("--device", default=None, help="default: the GPU")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = creg.get_config(args.arch, reduced=True)
    md = mreg.get_model(cfg)
    params = md.init(0, device=device)
    if args.restore:
        params = checkpoint.restore(args.restore, params)

    B, S = args.batch, args.prompt_len
    gen = torch.Generator(device=device).manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, S), generator=gen, device=device,
                                     dtype=torch.int32)}
    if cfg.family == "audio":
        batch["frame_embeds"] = torch.randn(
            (B, cfg.enc_frames, cfg.d_model), generator=gen, device=device)
    if cfg.family == "vlm":
        batch["img_embeds"] = torch.randn(
            (B, cfg.n_image_tokens, cfg.d_model), generator=gen, device=device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def sample(logits):
        probs = torch.softmax(logits[:, -1].float() / args.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen).int()

    with torch.no_grad():
        t0 = time.time()
        logits, cache = md.prefill(params, batch)
        sync()
        t_prefill = time.time() - t0

        tok = sample(logits)
        outs = [tok]
        t1 = time.time()
        for _ in range(args.new_tokens - 1):
            logits, cache = md.decode(params, cache, tok)
            tok = sample(logits)
            outs.append(tok)
        sync()
        t_decode = time.time() - t1

    gen_tokens = torch.cat(outs, dim=1).cpu().numpy()
    print(f"{args.arch}: prefill {B}x{S} in {t_prefill:.2f}s | "
          f"{args.new_tokens} decode steps in {t_decode:.2f}s "
          f"({B * args.new_tokens / max(t_decode, 1e-9):.1f} tok/s aggregate)")
    for b in range(min(B, 4)):
        print(f"  request {b}: {np.asarray(gen_tokens[b]).tolist()}")


if __name__ == "__main__":
    main()
