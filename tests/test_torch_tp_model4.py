"""Megatron tensor parallelism and FSDP placements on (model 4) under ``DEFAULT_RULES``: the smoke configs' two KV heads do not split four ways, so every family takes the head_dim fallback (k and v gathered whole).

Each family's smoke config (whisper, qwen3-1.7b, gemma-2b's head_dim
fallback, qwen3-moe tensor- and expert-parallel, llava, jamba's period)
runs on gloo ranks on the CPU with the same weights and batch as the
port's one-rank model (torch_tp_common); the one-rank model is itself
held to the reference by the family tests. Held per family: the loss, the
clip norm, every synced gradient leaf gathered whole, the params after one
synced AdamW step (1e-5, each leaf in relative L2), the gradient of every
leaf equal on every rank; the prefill's and three decode steps' logits
within 1e-5 of their largest element, the greedy tokens equal.
"""
import pytest

torch = pytest.importorskip("torch")

import torch_tp_common as T  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402

N_DATA, N_MODEL, RULES = 1, 4, "default"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    res = run_ranks(T.family_rank, N_DATA, N_MODEL, device="cpu",
                    backend="gloo", rdv_dir=tmp_path_factory.mktemp("rdv"),
                    args=(RULES, T.FAMILIES), timeout_s=T.TIMEOUT)
    return res, T.one_rank(T.FAMILIES, N_DATA)


@pytest.mark.parametrize("arch", T.FAMILIES)
def test_loss_grads_and_step_match_one_rank(runs, arch):
    T.check_loss_and_grads(*runs, arch)


@pytest.mark.parametrize("arch", T.FAMILIES)
def test_serving_matches_one_rank(runs, arch):
    T.check_serving(*runs, arch)
