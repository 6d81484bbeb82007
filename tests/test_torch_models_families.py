"""The audio (whisper), SSM (falcon-mamba), hybrid (recurrentgemma) and
VLM (llama-3.2-vision) architectures of the LM zoo in the port against the
JAX package; the cases and their tolerances are in
``tests/torch_lm_cases.py`` (forward atol 1e-5 + rtol 1e-5, gradients
atol 1e-5 + rtol 1e-4)."""
import pytest
import torch

import torch_lm_cases as cases

ARCHS = ["whisper-tiny", "falcon-mamba-7b", "recurrentgemma-9b", "llama-3.2-vision-11b"]


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_tree_matches_jax(arch):
    cases.check_init_tree_matches_jax(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_jax(arch):
    cases.check_loss_matches_jax(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_grad_matches_jax(arch):
    cases.check_grad_matches_jax(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_jax(arch):
    cases.check_prefill_matches_jax(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_jax(arch):
    cases.check_decode_matches_jax(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_teacher_forced(arch):
    cases.check_decode_matches_teacher_forced(arch)


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "recurrentgemma-9b"])
def test_multi_token_decode_stable(arch):
    cases.check_multi_token_decode_stable(arch)
