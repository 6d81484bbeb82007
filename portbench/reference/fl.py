"""The plain ColRel rounds (paper Algs. 1 and 2) that decide ``correct``.

Per round r, from the global model x: every client i runs T steps of SGD
with weight decay on its own minibatches, one client after another,
p ← p − lr·(∇loss(p) + wd·p), and sends Δ_i = p − x; the relays mix
Δ̃_j = Σ_i α_ji Δ_i, the server hears relay j with τ_j ~ Bernoulli(p_j)
and adds u = (1/n)·Σ_j τ_j Δ̃_j = (1/n)·Σ_i (τᵀA)_i Δ_i, summed in
ascending i.  The round's loss is the clients' mean loss at their first
step.  Under a churn mask a (the round's members), a departed client
neither relays nor is relayed nor heard: A's rows and columns outside a
and τ outside a are zeroed, and 1/n and the loss's mean are over the
members.  The batches are drawn again from the loader's seed
(``numpy.random.default_rng``: one ``choice(part, (T, b))`` a client a
round), τ from a ``torch.Generator`` on the device seeded as the port's,
one ``bernoulli(p_r)`` a round, and the channel states and relay matrices
from :mod:`portbench.generator`'s reference side.  Imports nothing of the port.
"""
from __future__ import annotations

import contextlib
import importlib

import numpy as np
import torch


@contextlib.contextmanager
def precision(mode: str):
    """``f32``: full float32 matmuls and convolutions (TF32 off) and
    deterministic cuDNN; ``tf32``: the same with TF32 on, the precision one
    step below the configuration's (the control)."""
    b = torch.backends
    saved = (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32, b.cudnn.deterministic,
             b.cudnn.benchmark)
    tf32 = {"f32": False, "tf32": True}[mode]
    b.cuda.matmul.allow_tf32 = b.cudnn.allow_tf32 = tf32
    b.cudnn.deterministic, b.cudnn.benchmark = True, False
    try:
        yield
    finally:
        (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32, b.cudnn.deterministic,
         b.cudnn.benchmark) = saved


def batch_stream(ds, parts, seed: int, rounds: int, T: int, b: int, *, lm: bool = False):
    """The first ``rounds`` rounds' (inputs (n, T, b, ...), labels (n, T, b,
    ...)), one round at a time; where ``lm``, each row is a token sequence
    and the pair is its tokens ``x[..., :-1]`` and targets ``x[..., 1:]``."""
    rng = np.random.default_rng(seed)
    for _ in range(rounds):
        idx = np.stack([rng.choice(part, size=(T, b), replace=True) for part in parts])
        x = ds.inputs[idx]
        yield (x[..., :-1], x[..., 1:]) if lm else (x, ds.labels[idx])


def taus(seed: int, ps, device) -> list[torch.Tensor]:
    gen = torch.Generator(device=device).manual_seed(seed)
    return [torch.bernoulli(torch.as_tensor(p, dtype=torch.float32, device=device),
                            generator=gen) for p in ps]


def local_update(loss_fn, x: dict, inputs, labels, *, lr: float, wd: float,
                 fault: str | None = None):
    """One client's T steps from x on its (T, b, ...) inputs and labels:
    (Δ as a flat dict of leaves, first loss)."""
    p = {k: v.clone().requires_grad_(True) for k, v in x.items()}
    first = None
    for t in range(inputs.shape[0]):
        xs, ys = inputs[t], labels[t]
        if fault == "half_batch":
            xs, ys = xs[: xs.shape[0] // 2], ys[: ys.shape[0] // 2]
        loss = loss_fn(unflatten(p), xs, ys)
        grads = torch.autograd.grad(loss, list(p.values()))
        with torch.no_grad():
            p = {k: (v - lr * (g + wd * v)).requires_grad_(True)
                 for (k, v), g in zip(p.items(), grads)}
        if first is None:
            first = loss.detach()
    return {k: p[k].detach().sub_(x[k]) for k in x}, first


def run_rounds(model: str, x0: dict, batches, tau_list, A_list, active_list, *, lr: float,
               wd: float, device, fault: str | None = None, keep=None):
    """The reference's rounds from the flat parameters ``x0`` (leaf name →
    tensor); ``active_list`` holds each round's membership mask, or None
    where every client takes part.  Each round's coefficients w·(τᵀA) come
    first, and each client's coefficient × Δ_i is added into the round's
    update u as soon as that client finishes, in ascending i, so no more
    than one client's weights are held at a time.  Returns (per-round
    losses, ``keep`` of x after the first round, ``keep`` of x after the
    last); ``keep`` (default: a copy) is applied as soon as x is made."""
    keep = keep or (lambda x: {k: v.clone() for k, v in x.items()})
    loss_fn = importlib.import_module(f"portbench.reference.{model}").loss
    x = {k: v.to(device=device, dtype=torch.float32).clone() for k, v in x0.items()}
    losses, first_x = [], None
    for (inputs, labels), tau, A, active in zip(batches, tau_list, A_list, active_list,
                                                strict=True):
        n = inputs.shape[0]
        if fault == "relay_left_out":  # every relay forwards only its own update
            A = torch.eye(n)
        A = torch.as_tensor(A, dtype=torch.float32, device=device)
        if active is None:
            w = 1.0 / n
        else:
            a = torch.as_tensor(active, dtype=torch.float32, device=device)
            members = torch.clamp(a.sum(), min=1.0)
            w = 1.0 / members
            A, tau = A * a[:, None] * a[None, :], tau * a
        coeffs = w * (tau @ A)
        u = {k: torch.zeros_like(v) for k, v in x.items()}
        firsts = []
        for i in range(n):
            d, first = local_update(
                loss_fn, x, torch.as_tensor(np.ascontiguousarray(inputs[i]), device=device),
                torch.as_tensor(np.ascontiguousarray(labels[i]), device=device), lr=lr, wd=wd,
                fault=fault)
            for k in x:
                u[k] = u[k] + coeffs[i] * d[k]
            del d  # Δ_i freed before the next client runs
            firsts.append(first)
        firsts = torch.stack(firsts)
        loss = firsts.mean() if active is None else (firsts * a).sum() / members
        for k in x:
            x[k] = x[k] + u.pop(k)
        losses.append(float(loss))
        if first_x is None:
            first_x = keep(x)
    return losses, first_x, keep(x)


def unflatten(flat: dict) -> dict:
    """'a/b' leaf names → nested dicts."""
    out: dict = {}
    for key, v in flat.items():
        node = out
        *path, leaf = key.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = v
    return out


def flatten(tree: dict, prefix: str = "") -> dict:
    """Nested dicts → 'a/b' leaf names, in sorted key order."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, name + "/"))
        else:
            out[name] = v
    return out
