"""Phase 3f's table of training cases in ``chip_smoke.py``, on the CPU:
each cut keeps its arch's published widths and every layer kind of its
pattern; every ``GRAD_NEEDED`` pattern names parameters of the model the
gradient gate runs, and the gate leaves out only ``GRAD_GATE_EXCLUDES``;
``k6_calls`` counts the attention calls a train step makes (the model at
its smoke width and the case's depth, remat on) and
``train_attention_calls`` splits a forward's by shape; and each case's byte
reckoning stays under the card's 80 GB.  The models whose names and
shapes are read are built on the meta device: nothing is allocated."""

import fnmatch
import importlib.util
import os

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.launch import steps as tsteps
from repro_torch.models import blocks
from repro_torch.models.common import Init
from repro_torch.models.lm import _build_lm, init_lm, param_count

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()
CASES = list(CS.TRAIN_ARCH_CASES)


def _gate_config(arch):
    """The config phase 3f runs ``arch``'s gradient gate on."""
    if arch in CS.TRAIN_ARCH_CASES:
        return CS.train_config(arch)
    return configs.get(arch).with_(**{
        "qwen3-8b": {"n_layers": CS.TRAIN_QWEN_LAYERS},
        "phi3.5-moe": {"n_layers": CS.TRAIN_MOE_LAYERS}}.get(arch, {}))


def _names(cfg):
    model = _build_lm(cfg, Init(None, cfg.param_torch_dtype, "meta"))
    return [n for n, _ in model.named_parameters()]


@pytest.mark.parametrize("arch", CASES)
def test_cut_keeps_the_published_widths_and_every_layer_kind(arch):
    full, cut = configs.get(arch), CS.train_config(arch)
    changed = {f for f in full.__dataclass_fields__
               if getattr(full, f) != getattr(cut, f)}
    assert changed <= {"n_layers", "microbatches"}, changed
    assert 1 <= cut.n_layers <= full.n_layers
    # whole layer groups, each recomputed in the backward
    assert cut.n_layers % len(cut.pattern) == 0
    assert CS.layer_kinds(cut) == CS.layer_kinds(full)


@pytest.mark.parametrize("arch", list(CS.GRAD_NEEDED))
def test_grad_needed_names_parameters_of_the_gated_model(arch):
    cfg = _gate_config(arch)
    names = _names(cfg)
    gated = [n for n in names if CS.gated(arch, n)]
    # one tensor a layer that has the projection
    n_attn = sum(cfg.pattern[i % len(cfg.pattern)] in "AL"
                 for i in range(cfg.n_layers))
    per_layer = {cfg.n_layers, cfg.enc_layers, n_attn}
    for pat in CS.GRAD_NEEDED[arch]:
        hits = [n for n in gated if fnmatch.fnmatchcase(n, pat)]
        assert hits, pat
        assert len(hits) in per_layer, (pat, hits)
    left_out = set(names) - set(gated)
    assert all(any(fnmatch.fnmatchcase(n, p)
                   for p in CS.GRAD_GATE_EXCLUDES.get(arch, ()))
               for n in left_out)
    # what arctic-480b's gate leaves out is its routed experts alone
    assert {n.rsplit(".", 1)[-1] for n in left_out} <= {"wi", "wo"}


@pytest.mark.parametrize("arch", CASES + ["qwen3-8b", "phi3.5-moe"])
def test_k6_calls_counts_a_train_steps_attention_calls(arch, monkeypatch):
    """``k6_calls(cfg)[1]`` a microbatch: each attention call of the
    forward (the encoder's, the decoder's and the cross-attentions) and
    again in the remat recompute; counted at the smoke width with the
    case's depth."""
    cut = _gate_config(arch)
    cfg = configs.get_smoke(arch).with_(
        n_layers=cut.n_layers, enc_layers=cut.enc_layers,
        microbatches=cut.microbatches if arch != "phi3.5-moe" else 2,
        remat="full")
    calls = []

    def counted(*args, **kw):
        calls.append(1)
        return attention(*args, **kw)

    attention = blocks.attention
    monkeypatch.setattr(blocks, "attention", counted)
    params = init_lm(cfg, torch.Generator().manual_seed(0), "cpu")
    params.requires_grad_(True)
    B, S = 2 * cfg.microbatches, 16
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1))
    batch = {"tokens": torch.from_numpy(toks[:, :-1]),
             "labels": torch.from_numpy(toks[:, 1:])}
    if cfg.is_encdec:
        batch["frames"] = torch.randn(B, S, cfg.frontend_dim)
    elif cfg.frontend_dim:
        batch["patches"] = torch.randn(B, cfg.frontend_tokens,
                                       cfg.frontend_dim)
    tsteps.loss_and_grads(params, batch, cfg)
    assert len(calls) == CS.k6_calls(cfg)[1] * cfg.microbatches
    assert CS.k6_calls(cut) == CS.k6_calls(cfg)
    # the calls a forward makes at each shape, whose backwards
    # k6_backward_share adds up
    by_shape = CS.train_attention_calls(cut)
    assert by_shape.keys() == CS.train_attention_shapes(cut, 2048).keys()
    assert sum(by_shape.values()) == CS.k6_calls(cut)[0]


@pytest.mark.parametrize("arch", CASES)
def test_reckoning_fits_the_card(arch):
    cfg = CS.train_config(arch)
    rk = CS.train_reckoning(arch, cfg, CS.TRAIN_ARCH_CASES[arch][1],
                            CS.TRAIN_SEQ)
    assert rk["params"] == param_count(cfg)
    assert rk["weights"] == 2 * rk["params"]
    if cfg.optimizer == "adamw":
        assert rk["moments"] == 8 * rk["params"]
    else:   # Adafactor's factored rows and columns: arctic's expert wi
        E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
        assert 4 * E * d * f <= rk["moments"] < 4 * E * d * f * 1.01
    assert max(rk["step"], rk["gate"]) == rk["peak"] < CS.CARD_BYTES
