"""Port: the LM families and the private-embedding twin on the card.

Marked ``cuda``: they skip without a card (``pytest -m cuda
tests/test_torch_lm_card.py`` on the card). The CPU's plain model is the
reference here: the JAX package is compared in the CPU tests
(``test_torch_models.py``, ``test_torch_private_inference.py``).
``chip_smoke.py private_lm`` drives the same path at qwen3-4b's full size,
``vlm_serve`` at llava-next-34b's full width.
"""
from dataclasses import replace

import numpy as np
import pytest
import torch

from repro_torch import private_inference as pi
from repro_torch.configs import SMOKES
from repro_torch.models import build_model


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m cuda on the card; "
                    "chip_smoke.py's private_lm holds the same path at "
                    "full size)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_model_on_the_card_matches_the_cpu(card):
    """float32 smoke qwen3: weights drawn on the CPU and copied over; the
    card's forward and cached decode equal the CPU's within 1e-4."""
    cfg = replace(SMOKES["qwen3-4b"], dtype="float32")
    cpu = build_model(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(0))
    dev = build_model(cfg, device=card)
    dev.load_state_dict(cpu.state_dict())
    tok = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 35)))
    want, _ = cpu.forward(tok)
    got, _ = dev.forward(tok.to(card))
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=0)
    _, cache = dev.prefill(tok[:, :32].to(card), capacity=35)
    for i in range(3):
        step, cache = dev.decode(cache, tok[:, 32 + i:33 + i].to(card))
        torch.testing.assert_close(step.cpu(), want[:, 32 + i], atol=1e-4,
                                   rtol=0)
    assert cache.length.device.type == "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "grok-1-314b"])
def test_moe_model_on_the_card_matches_the_cpu(card, arch):
    """float32 smoke MoE models (deepseek-v3: MLA, a dense layer, the MTP
    head, the gather at decode; grok-1: the batch-global dispatch): the
    card's forward, aux, loss, prefill and three cached decodes equal the
    CPU's within 1e-4 (the MoE decode is compared with the CPU's decode,
    not with the forward, whose dispatch may drop slots)."""
    cfg = replace(SMOKES[arch], dtype="float32")
    cpu = build_model(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(0))
    dev = build_model(cfg, device=card)
    dev.load_state_dict(cpu.state_dict())
    tok = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 35)))
    close = lambda got, want: torch.testing.assert_close(
        got.cpu(), want, atol=1e-4, rtol=0)
    for got, want in zip(dev.forward(tok.to(card)), cpu.forward(tok)):
        close(got, want)
    close(dev.loss(tok.to(card))[0], cpu.loss(tok)[0])
    caches = [m.prefill(tok[:, :32].to(m.device), capacity=35)[1]
              for m in (dev, cpu)]
    for i in range(3):
        step = tok[:, 32 + i:33 + i]
        got, caches[0] = dev.decode(caches[0], step.to(card))
        want, caches[1] = cpu.decode(caches[1], step)
        close(got, want)
    close(caches[0].k, caches[1].k)


@pytest.mark.cuda
@pytest.mark.parametrize("vocab,kernel", [(1 << 10, "dpxor"),
                                          (1 << 13, "fused_scan_xor")])
def test_private_inference_on_the_kernels(card, vocab, kernel):
    """The twin on the card: rows bit-exact, tokens equal to plain
    lookups, the batches on the kernels and no plain call. A table of at
    most 2^12 rows takes materialize + B1 at every bucket; 2^13 rows take
    B2 at the 4-stream steps."""
    cfg = replace(pi.PI_LM, vocab=vocab)
    model = build_model(cfg, device=card).init_params(
        torch.Generator(card).manual_seed(3))
    out = pi.run(model=model, tokens=3, streams=4, seed=3, verbose=False)
    assert out["rows_exact"] and out["plain_equal"]
    assert out["launches"][kernel] >= 1 and out["launches"]["dpxor"] >= 1
    assert not any(out["plain_calls"].values())


@pytest.mark.cuda
def test_vlm_model_on_the_card_matches_the_cpu(card):
    """float32 smoke llava with a prefix of patch embeddings: the card's
    forward, loss, prefill (length P + S) and three cached decodes equal
    the CPU's within 1e-4."""
    cfg = replace(SMOKES["llava-next-34b"], dtype="float32")
    cpu = build_model(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(0))
    dev = build_model(cfg, device=card)
    dev.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(1)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 27)))
    pre = torch.from_numpy(rng.standard_normal(
        (2, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32))
    close = lambda got, want: torch.testing.assert_close(
        got.cpu(), want, atol=1e-4, rtol=0)
    want, _ = cpu.forward(tok, prefix_embeds=pre)
    close(dev.forward(tok.to(card), prefix_embeds=pre.to(card))[0], want)
    close(dev.loss(tok.to(card), prefix_embeds=pre.to(card))[0],
          cpu.loss(tok, prefix_embeds=pre)[0])
    _, cache = dev.prefill(tok[:, :24].to(card), prefix_embeds=pre.to(card),
                           capacity=8 + 27)
    assert int(cache.length) == 8 + 24
    for i in range(3):
        step, cache = dev.decode(cache, tok[:, 24 + i:25 + i].to(card))
        close(step, want[:, 8 + 24 + i])


@pytest.mark.cuda
def test_private_inference_with_a_prefix_on_the_kernels(card):
    """The twin at llava SMOKE on the card: each stream's prefix stays on
    the client, its text tokens' rows come through the kernels bit-exact,
    the tokens equal plain lookups', no plain call."""
    cfg = replace(SMOKES["llava-next-34b"], vocab=1 << 13)
    model = build_model(cfg, device=card).init_params(
        torch.Generator(card).manual_seed(3))
    out = pi.run(model=model, tokens=3, streams=4, seed=3, verbose=False)
    assert out["rows_exact"] and out["plain_equal"]
    assert out["prefix_rows"] == cfg.n_frontend_tokens
    assert out["launches"]["fused_scan_xor"] >= 1
    assert out["launches"]["dpxor"] >= 1
    assert not any(out["plain_calls"].values())


@pytest.mark.cuda
def test_database_takes_a_card_tensor_over(card):
    """On the card a words tensor becomes the database's rows without a
    copy (ownership passes to the database); nothing crosses from the
    host."""
    from repro_torch.config import PIRConfig
    from repro_torch.db import Database
    words = torch.arange(128, dtype=torch.int32, device=card).reshape(64, 2)
    db = Database(words, PIRConfig(n_items=64, item_bytes=8), card)
    assert db.view("words").data_ptr() == words.data_ptr()
    assert db.stats.preload_h2d_bytes == 0
