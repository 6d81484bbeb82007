"""ColRel rounds of an LM, and the two service command lines, in the port.

* One ``FLSimulator`` round of glm4-9b and mixtral-8x22b at ``reduced()``
  (n = 4 clients, T = 2 local steps of batch 2, sequence 64 from
  ``lm_tokens``) against the JAX package's round, for ``colrel`` on the
  ``hopper`` backend and ``colrel_fused`` on ``hopper_fused`` (their plain
  versions on the CPU).  τ, the initial parameters and the batches come
  from the JAX side and are handed over as arrays.  Tolerance: atol 1e-5 +
  rtol 1e-5 on the parameters and the round's metrics.
* ``launch/train.py::main`` for 2 rounds and ``launch/serve.py::main``
  (one-shot and watching the trainer's snapshots) with ``--device cpu``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jax_creg
from repro.core import opt_alpha as jax_opt
from repro.core import topology as jax_top
from repro.fl.simulator import FLSimulator as JaxSimulator
from repro.models import registry as jax_mreg
from repro_torch.configs import registry as creg
from repro_torch.data.loader import FederatedLoader
from repro_torch.data.partition import iid_partition
from repro_torch.data.synthetic import lm_tokens
from repro_torch.fl.simulator import FLSimulator
from repro_torch.models import get_model
from repro_torch.utils import from_jax_params, tree_flatten

N, T, B, SEQ, LR = 4, 2, 2, 64, 0.1
P = np.array([0.3, 0.6, 0.9, 0.5], np.float32)
TOL = dict(atol=1e-5, rtol=1e-5)
RUNS = [("colrel", "hopper"), ("colrel_fused", "hopper_fused")]


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@functools.cache
def _setup(arch):
    cfg = jax_creg.get_config(arch, reduced=True)
    md = jax_mreg.get_model(cfg)
    A = jax_opt.optimize(P, jax_top.ring(N, k=1)).A
    params = md.init(jax.random.key(0))
    ds = lm_tokens(256, SEQ, vocab=cfg.vocab, seed=0)
    loader = FederatedLoader(ds, iid_partition(ds, N, seed=0), seed=0)
    batch = loader.round_batch(T, B, lm=True)
    tau = np.asarray(jax.random.bernoulli(jax.random.key(7), jnp.asarray(P)), np.float32)
    shared_update = jax.jit(JaxSimulator(md.loss, n_clients=N, local_steps=T,
                                         strategy="no_dropout")._client_update)
    return md, A, params, batch, tau, shared_update


@functools.cache
def jax_round(arch, strategy):
    md, A, params, batch, tau, shared_update = _setup(arch)
    sim = JaxSimulator(md.loss, n_clients=N, strategy=strategy, A=A, p=P, local_steps=T)
    sim._client_update = shared_update
    new_params, _, metrics = sim._round_math(
        params, None, jax.tree.map(jnp.asarray, batch), jnp.asarray(tau), sim.A, LR, None)
    return jax.tree.map(np.asarray, (new_params, metrics))


@pytest.mark.parametrize("strategy,backend", RUNS)
@pytest.mark.parametrize("arch", ["glm4-9b", "mixtral-8x22b"])
def test_lm_colrel_round_matches_jax(arch, strategy, backend):
    jmd, A, jparams, batch, tau, _ = _setup(arch)
    md = get_model(creg.get_config(arch, reduced=True))
    sim = FLSimulator(md.loss, n_clients=N, strategy=strategy, A=A, p=P, local_steps=T,
                      relay_backend=backend, device="cpu")
    params = from_jax_params(jax.tree.map(np.asarray, jparams), device="cpu")
    new_params, _, metrics = sim.run_round(None, params, sim.init_server_state(params),
                                           batch, LR, tau=tau)
    want_params, want_metrics = jax_round(arch, strategy)
    got, want = tree_flatten(new_params)[0], jax.tree.leaves(want_params)
    assert len(got) == len(want)
    moved = 0
    for g, w, w0 in zip(got, want, jax.tree.leaves(jparams)):
        np.testing.assert_allclose(g.numpy(), w, **TOL)
        moved += not np.array_equal(w, np.asarray(w0))
    assert moved > len(want) // 2  # the round trained the model
    for name in ("loss", "tau", "delta_norm"):
        np.testing.assert_allclose(metrics[name].numpy(), want_metrics[name], **TOL)


def test_train_main_runs_two_rounds_and_publishes(tmp_path, capsys):
    from repro_torch.launch import train

    ckpt = tmp_path / "ckpt"
    train.main(["--device", "cpu", "--rounds", "2", "--clients", "4", "--local-steps", "1",
                "--local-batch", "2", "--log-every", "1", "--publish-every", "1",
                "--ckpt-dir", str(ckpt), "--arch", "glm4-9b"])
    out = capsys.readouterr().out
    losses = [float(line.split("loss=")[1].split()[0]) for line in out.splitlines()
              if line.startswith("round")]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert out.count("published") == 2

    from repro_torch.launch import serve

    serve.main(["--device", "cpu", "--arch", "glm4-9b", "--watch", str(ckpt),
                "--max-polls", "1", "--poll-interval", "0", "--batch", "2",
                "--prompt-len", "16"])
    evals = [line for line in capsys.readouterr().out.splitlines() if "eval_loss" in line]
    assert len(evals) == 1 and evals[0].startswith("round    2")


@pytest.mark.parametrize("arch", ["glm4-9b", "falcon-mamba-7b", "whisper-tiny"])
def test_serve_main_decodes_on_the_cpu(arch, capsys):
    from repro_torch.launch import serve

    serve.main(["--device", "cpu", "--arch", arch, "--batch", "2", "--prompt-len", "16",
                "--new-tokens", "5"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("prefill: 2x16")
    tokens = [eval(line.split(": ", 1)[1]) for line in out[1:]]
    assert len(tokens) == 2 and all(len(t) == 5 for t in tokens)
    vocab = creg.get_config(arch, reduced=True).vocab
    assert all(0 <= x < vocab for t in tokens for x in t)


def test_decode_demo_returns_what_it_ran(capsys):
    """The decode demo's greedy tokens are the argmax of the logits it
    returns, and its first decode step equals teacher forcing."""
    import argparse

    from repro_torch.launch import serve

    cfg = creg.get_config("glm4-9b", reduced=True)
    md = get_model(cfg)
    params = md.init(0, device="cpu")
    args = argparse.Namespace(batch=2, prompt_len=12, new_tokens=4, seed=0)
    out = serve._decode_demo(md, cfg, params, args)
    assert out["generated"].shape == (2, 4) and len(out["decode_logits"]) == 3
    for i, logits in enumerate(out["decode_logits"]):
        assert np.array_equal(logits[:, -1].argmax(-1).numpy(), out["generated"][:, i + 1])
    prompt = out["batch"]["tokens"]
    forced = torch.cat([prompt, torch.from_numpy(out["generated"][:, :1]).int()], dim=1)
    full, _ = md.prefill(params, {"tokens": forced})
    np.testing.assert_allclose(out["decode_logits"][0].numpy(), full.numpy(), atol=1e-5,
                               rtol=1e-5)
