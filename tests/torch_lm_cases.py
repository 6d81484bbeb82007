"""The LM model zoo in the port against the JAX package: the cases that
``tests/test_torch_models.py`` (dense and MoE) and
``tests/test_torch_models_families.py`` (audio, SSM, hybrid, VLM) run for
each architecture at its ``reduced()`` config (B = 2, S = 96, f32).  Not a
test module: two files split the architectures so that their JAX compiles
run on two test workers.

The JAX side inits the parameters (threefry cannot be replayed in torch),
and ``from_jax_params`` carries them across.  Compared:

* the parameter tree: the port's own init has the JAX init's flattened leaf
  order, shapes and dtypes (the FL buffer's columns follow that order);
* ``loss`` and its gradient, ``prefill``'s last logits and cache, and one
  ``decode`` step's logits and cache;
* decode against teacher forcing, and multi-token decode stable, as
  ``tests/test_models_smoke.py`` checks the JAX package.

Tolerance: forward values atol 1e-5 + rtol 1e-5, gradients atol 1e-5 +
rtol 1e-4.  Each JAX function is jitted once per architecture and its
results are shared by the cases of that architecture.
"""
import dataclasses
import functools

import jax
import numpy as np
import torch

from repro.configs import registry as jax_creg
from repro.models import registry as jax_mreg
from repro_torch.configs import registry as creg
from repro_torch.models import get_model
from repro_torch.utils import from_jax_params, tree_flatten

ARCHS = list(creg.ASSIGNED)
B, S = 2, 96
FWD = dict(atol=1e-5, rtol=1e-5)
GRAD = dict(atol=1e-5, rtol=1e-4)


def _batch(cfg, seed=0, seq=S):
    """Numpy tokens (B, seq + 1) and the family's stub frontend input."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (B, seq + 1)).astype(np.int32)}
    if cfg.family == "audio":
        out["frame_embeds"] = rng.standard_normal((B, cfg.enc_frames, cfg.d_model)).astype(
            np.float32)
    if cfg.family == "vlm":
        out["img_embeds"] = rng.standard_normal(
            (B, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    return out


def _extra(data):
    return {k: v for k, v in data.items() if k != "tokens"}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _torch(tree):
    return from_jax_params(tree, device="cpu")


@functools.cache
def reference(arch):
    """The JAX package's results for one architecture, and its params."""
    cfg = jax_creg.get_config(arch, reduced=True)
    md = jax_mreg.get_model(cfg)
    params = md.init(jax.random.key(0))
    data = _batch(cfg)
    train = {"tokens": data["tokens"][:, :-1], "labels": data["tokens"][:, 1:], **_extra(data)}
    loss, grads = jax.jit(jax.value_and_grad(md.loss))(params, train)
    prompt = {"tokens": data["tokens"][:, :-1], **_extra(data)}
    logits, cache = jax.jit(md.prefill)(params, prompt)
    dlogits, dcache = jax.jit(md.decode)(params, cache, data["tokens"][:, -1:])
    return {"params": _np(params), "data": data, "train": train, "prompt": prompt,
            "loss": np.asarray(loss), "grads": _np(grads), "logits": np.asarray(logits),
            "cache": _np(cache), "dlogits": np.asarray(dlogits), "dcache": _np(dcache)}


def _port(arch, **replace):
    cfg = creg.get_config(arch, reduced=True)
    if replace:
        cfg = dataclasses.replace(cfg, **replace)
    return cfg, get_model(cfg)


def _close(got, want, tol):
    got_l, want_l = tree_flatten(got)[0], jax.tree.leaves(want)
    assert len(got_l) == len(want_l)
    for g, w in zip(got_l, want_l):
        g = g.detach().numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, w.shape, g.dtype, w.dtype)
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, **tol)


def check_init_tree_matches_jax(arch):
    """The port's own init: same leaves in the same flatten order, shapes
    and dtypes as the JAX init (values differ: another generator)."""
    ref = reference(arch)["params"]
    _, md = _port(arch)
    got = md.init(0, device="cpu")
    want_leaves, want_def = jax.tree.flatten(ref)
    got_leaves = tree_flatten(got)[0]
    assert [tuple(x.shape) for x in got_leaves] == [x.shape for x in want_leaves]
    assert [str(x.dtype).removeprefix("torch.") for x in got_leaves] == [
        str(x.dtype) for x in want_leaves]
    # the same tree: the port's leaves put back into the JAX treedef
    assert jax.tree.structure(jax.tree.unflatten(want_def, got_leaves)) == want_def
    assert all(bool(torch.isfinite(x).all()) for x in got_leaves)


def check_loss_matches_jax(arch):
    ref = reference(arch)
    _, md = _port(arch)
    loss = md.loss(_torch(ref["params"]), _torch(ref["train"]))
    np.testing.assert_allclose(loss.item(), ref["loss"], **FWD)


def check_grad_matches_jax(arch):
    ref = reference(arch)
    _, md = _port(arch)
    grads = torch.func.grad(md.loss)(_torch(ref["params"]), _torch(ref["train"]))
    _close(grads, ref["grads"], GRAD)


def check_prefill_matches_jax(arch):
    ref = reference(arch)
    _, md = _port(arch)
    logits, cache = md.prefill(_torch(ref["params"]), _torch(ref["prompt"]))
    _close(logits, ref["logits"], FWD)
    _close(cache, ref["cache"], FWD)


def check_decode_matches_jax(arch):
    """One decode step from the JAX package's prefill cache."""
    ref = reference(arch)
    _, md = _port(arch)
    logits, cache = md.decode(_torch(ref["params"]), _torch(ref["cache"]),
                              torch.from_numpy(ref["data"]["tokens"][:, -1:]))
    _close(logits, ref["dlogits"], FWD)
    _close(cache, ref["dcache"], FWD)


def check_decode_matches_teacher_forced(arch):
    """The port on its own: prefill(S) + decode of token S equals the last
    logits of prefill(S + 1), within the reference test's bar."""
    cfg, _ = _port(arch)
    replace = {}
    if cfg.family == "moe":
        # capacity dropping is batch-dependent; generous capacity routes
        # prefill and decode alike, as the reference test does
        replace["moe"] = dataclasses.replace(cfg.moe, capacity_factor=8.0)
    cfg, md = _port(arch, **replace)
    params = _torch(reference(arch)["params"])
    data = _torch(_batch(cfg, seed=3))
    tk, extra = data["tokens"], _extra(data)
    lg_full, _ = md.prefill(params, {"tokens": tk, **extra})
    _, cache = md.prefill(params, {"tokens": tk[:, :S], **extra})
    lg_dec, _ = md.decode(params, cache, tk[:, S:S + 1])
    rel = (lg_full - lg_dec).abs().max() / lg_full.abs().max().clamp(min=1e-9)
    assert rel < 2e-3, f"{arch}: decode/teacher-forced mismatch {rel:.2e}"
    assert lg_dec.shape == (B, 1, cfg.vocab)


def check_multi_token_decode_stable(arch):
    _, md = _port(arch)
    params = _torch(reference(arch)["params"])
    tk = torch.from_numpy(_batch(md.cfg, seed=5, seq=31)["tokens"])
    logits, cache = md.prefill(params, {"tokens": tk})
    tok = logits[:, -1].argmax(-1)[:, None]
    for _ in range(8):
        logits, cache = md.decode(params, cache, tok)
        assert torch.isfinite(logits).all()
        tok = logits[:, -1].argmax(-1)[:, None]
    assert int(cache["t"]) == 32 + 8


def check_moe_routing_matches_jax(arch):
    """Each MoE layer's top-k expert ids on the same input equal the
    reference's routing (softmax over the router, ``lax.top_k``)."""
    from repro.models import common as jcommon
    from repro_torch.models import moe

    ref = reference(arch)
    cfg, _ = _port(arch)
    blocks = _torch(ref["params"])["blocks"]["moe"]
    x = np.random.default_rng(11).standard_normal((B, S, cfg.d_model)).astype(np.float32)
    for layer in range(cfg.n_layers):
        p = {k: v[layer] for k, v in blocks.items() if k != "router"}
        p["router"] = {"w": blocks["router"]["w"][layer]}
        _, _, ids = moe._route(p, torch.from_numpy(x), cfg)
        router = jax.tree.map(lambda a: a[layer], ref["params"]["blocks"]["moe"]["router"])
        probs = jax.nn.softmax(jcommon.dense(router, x, cdtype=np.float32), axis=-1)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jax.lax.top_k(probs, cfg.moe.top_k)[1]))
