"""Private-embedding LM serving twin: the Lam et al. use case end to end,
as ``examples/private_inference.py`` runs it on the JAX package.

A client runs an LM but must not reveal its token stream to the hosts of
the embedding table. Per token:

  1. the client DPF-encodes the token id into two keys,
  2. two non-colluding servers answer with XOR shares of the embedding
     row (bf16 bit-exact: the table is served as 32-bit words),
  3. the client reconstructs the row, runs the transformer locally, and
     greedily picks the next token.

Several streams share each PIR batch (the paper's query batching, §3.4).
The table, padded to 2^k rows, is the servers' copy on the device
(``table_as_words`` is a view of it, never a host copy). Where the
reference recomputes the whole trunk from all the stream's embeddings each
step, the twin prefills from the prompt's and decodes one token at a time
with the KV cache, so each new token costs one private lookup per stream.
It then checks that every retrieved row equals the model's embedding row
bit for bit, that the same loop on plain lookups (``embed_lookup``) generates the
same tokens, and serves one more step for stream 0 alone (one query).

A VLM client (llava-next-34b) also holds each stream's image, and an
audio client (whisper-small) each stream's audio: the family's side input
(``input_specs``' name beside ``tokens``: the patch embeddings
``prefix_embeds``, put ahead of the prompt, or the frame embeddings
``frame_embeds``, which the encoder reads) stays on the client, and only
the (decoder's) text tokens' rows are fetched through the servers. The
twin draws it from the seed as the training pipeline draws its stub
(normal x 0.02, numpy). An SSM client (xlstm-350m) is text-only; its
decode state is recurrent, not a KV cache, so the prefill's capacity is
ignored and each decode step advances the state. A hybrid client
(zamba2-7b) is text-only too; its cache holds both (every Mamba layer's
state and the shared block's KV caches), every field but ``length``
``[Layers, B, ...]``, so a stream's slice is taken as a KV cache's.

Run:  PYTHONPATH=src python -m repro_torch.private_inference [--device cpu]
      [--tokens 8] [--streams 2]
      [--arch pi-lm | qwen3-4b | deepseek-v3-671b | grok-1-314b
       | llava-next-34b | whisper-small | xlstm-350m | zamba2-7b
       [--smoke]]
(the default device is the CUDA card; without one it raises). The last
line printed is a JSON summary; a wrong row or token exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Callable, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.config import ModelConfig, PIRConfig, ShapeConfig
from repro_torch.configs import get_arch
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.engine.backend import Device, resolve_device
from repro_torch.kernels import ops
from repro_torch.models import EncDecLM, build_model, input_specs
from repro_torch.models.hybrid import Zamba2Model
from repro_torch.models.layers import embed_lookup, pad_vocab
from repro_torch.models.transformer import TransformerLM
from repro_torch.models.xlstm import XLSTMCache, XLSTMModel
from repro_torch.runtime.serve_loop import TwoServerPIR

#: the twin's model: a decoder-only LM, the audio family's encoder-decoder,
#: the SSM family's xLSTM or the hybrid family's Zamba2
Model = Union[TransformerLM, EncDecLM, XLSTMModel, Zamba2Model]

#: the example's model (``examples/private_inference.py:48``)
PI_LM = ModelConfig(name="pi-lm", family="dense", n_layers=2, d_model=64,
                    n_heads=4, n_kv_heads=2, d_ff=128, vocab=1 << 10,
                    attn_chunk=16)

#: the largest batch bucket of the twin's servers
MAX_BUCKET = 32


def table_as_words(table: torch.Tensor) -> torch.Tensor:
    """``[V, d]`` bf16 -> ``[V, d/2]`` int32 words (the PIR payload view):
    the same memory, word ``w`` holding element ``2w`` in its low half and
    ``2w + 1`` in its high half (little-endian), as the reference packs
    it on the host."""
    if table.dtype != torch.bfloat16 or table.shape[-1] % 2:
        raise ValueError(f"expected [V, even d] bf16, got "
                         f"{tuple(table.shape)} {table.dtype}")
    return table.contiguous().view(torch.int32)


def words_as_rows(words: torch.Tensor, d: int) -> torch.Tensor:
    """``[..., d/2]`` int32 words -> ``[..., d]`` bf16 rows (the inverse of
    :func:`table_as_words`)."""
    if words.dtype != torch.int32 or 2 * words.shape[-1] != d:
        raise ValueError(f"expected [..., {d // 2}] int32 words, got "
                         f"{tuple(words.shape)} {words.dtype}")
    return words.contiguous().view(torch.bfloat16)


def padded_rows(vocab: int) -> int:
    """The PIR domain: the padded vocabulary rounded up to 2^k rows."""
    return 1 << (pad_vocab(vocab) - 1).bit_length()


def padded_table(model: Model) -> torch.Tensor:
    """The servers' copy of ``model.embed``: ``[padded_rows(V), d]`` bf16
    on the model's device, rows past the table zero."""
    cfg = model.cfg
    table = torch.zeros((padded_rows(cfg.vocab), cfg.d_model),
                        dtype=torch.bfloat16, device=model.device)
    table[:model.embed.shape[0]] = model.embed
    return table


class PrivateEmbedding:
    """The client's embedding lookups through ``TwoServerPIR``.

    The servers hold :func:`padded_table`, as words, handed over to their
    database (no copy on the card; nothing here keeps a reference). A call
    retrieves the rows of a batch of token ids privately and returns them
    as bf16 on the model's device; ``log`` keeps each batch's ids and words
    for :meth:`check_rows`, and its seconds (host clock: keygen, both
    servers' answers, reconstruction)."""

    def __init__(self, model: Model, *,
                 client_rng: np.random.Generator):
        cfg = model.cfg
        self.model = model
        self.d = cfg.d_model
        self.device = model.device
        self.pir_cfg = PIRConfig(n_items=padded_rows(cfg.vocab),
                                 item_bytes=cfg.d_model * 2,
                                 batch_queries=MAX_BUCKET)
        self.system = TwoServerPIR(table_as_words(padded_table(model)),
                                   self.pir_cfg, device=model.device,
                                   n_queries=MAX_BUCKET,
                                   client_rng=client_rng)
        self.log: List[dict] = []

    def __call__(self, token_ids: torch.Tensor) -> torch.Tensor:
        ids = [int(t) for t in token_ids.reshape(-1).tolist()]
        t0 = time.perf_counter()
        records = self.system.query(ids)          # [n, d/2] u32, on the host
        words = torch.from_numpy(records.view(np.int32)).to(self.device)
        seconds = time.perf_counter() - t0
        self.log.append({"ids": ids, "words": words, "seconds": seconds})
        return words_as_rows(words, self.d)

    def check_rows(self) -> bool:
        """Every retrieved row bit-equal to the model's own embedding row
        (``model.embed``, not the servers' memory; zero past its rows)."""
        table = table_as_words(self.model.embed.detach())
        for e in self.log:
            ids = torch.tensor(e["ids"], device=self.device)
            inside = ids < table.shape[0]
            want = torch.zeros_like(e["words"])
            want[inside] = table[ids[inside]]
            if not torch.equal(e["words"], want):
                return False
        return True


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def side_input(cfg: ModelConfig) -> Optional[str]:
    """The family's client-side input beside ``tokens``, by its
    ``input_specs`` name (``prefix_embeds`` for a VLM, ``frame_embeds`` for
    audio), or None for a text-only family."""
    shape = ShapeConfig(name="side_input", seq_len=cfg.n_frontend_tokens + 1,
                        global_batch=1, kind="prefill")
    names = sorted(set(input_specs(cfg, shape)) - {"tokens"})
    return names[0] if names else None


def generate(model: Model, embed: Callable, prompt: torch.Tensor,
             n_new: int, prefix: Optional[torch.Tensor] = None) -> dict:
    """Greedy generation of ``n_new`` tokens per stream from ``prompt``
    ``[B, T]``: one ``embed`` call for the prompt, a prefill from those
    embeddings with the client's ``prefix`` if given (the family's side
    input, :func:`side_input`: a VLM's ``[B, P, d]`` rows ahead of the
    prompt, cache capacity P + T + n_new; an audio model's frames, which
    take no decoder position, capacity T + n_new), then one ``embed`` call
    and one cached decode per further token. Returns the tokens ``[B, T +
    n_new]``, the cache, the last logits, and per step the seconds spent
    in ``embed`` and in the trunk (host clock, the token read back)."""
    b, t = prompt.shape
    d, vocab = model.cfg.d_model, model.cfg.vocab
    dev = model.device
    side = {} if prefix is None else {side_input(model.cfg): prefix}
    ahead = prefix.shape[1] if "prefix_embeds" in side else 0
    steps = []
    t0 = time.perf_counter()
    x = embed(prompt.reshape(-1)).reshape(b, t, d)
    t1 = time.perf_counter()
    logits, cache = model.prefill(embeds=x, capacity=ahead + t + n_new,
                                  **side)
    nxt = logits[:, :vocab].argmax(dim=-1)
    out = [nxt.cpu()]
    steps.append({"lookups": b * t, "embed_s": t1 - t0,
                  "trunk_s": time.perf_counter() - t1})
    for _ in range(n_new - 1):
        t0 = time.perf_counter()
        x = embed(nxt).reshape(b, 1, d)
        t1 = time.perf_counter()
        logits, cache = model.decode(cache, embeds=x, write=True)
        nxt = logits[:, :vocab].argmax(dim=-1)
        out.append(nxt.cpu())
        steps.append({"lookups": b, "embed_s": t1 - t0,
                      "trunk_s": time.perf_counter() - t1})
    _sync(dev)
    tokens = torch.cat([prompt.cpu()] + [o[:, None] for o in out], dim=1)
    return {"tokens": tokens, "cache": cache, "logits": logits,
            "steps": steps}


def solo_step(model: Model, embed: Callable, gen: dict,
              stream: int = 0) -> int:
    """One more token for ``stream`` alone: one lookup (a batch of one
    query) and a decode on that stream's slice of the cache (every field
    but ``length`` of a KV cache, an encoder-decoder's and a hybrid's is
    ``[Layers, B, ...]``; an xLSTM cache slices itself,
    :meth:`XLSTMCache.streams`)."""
    cache = gen["cache"]
    last = gen["tokens"][stream:stream + 1, -1].to(model.device)
    if isinstance(cache, XLSTMCache):
        one = cache.streams(stream, stream + 1)
    else:
        one = cache._replace(**{
            name: getattr(cache, name)[:, stream:stream + 1]
            for name in cache._fields if name != "length"})
    x = embed(last).reshape(1, 1, model.cfg.d_model)
    logits, _ = model.decode(one, embeds=x, write=False)
    return int(logits[0, :model.cfg.vocab].argmax())


def example_prompt(streams: int) -> np.ndarray:
    """The example's prompt: ``[[3 + i, 17, 41] for each stream i]``."""
    return np.asarray([[3 + i, 17, 41] for i in range(streams)], np.int64)


def client_prefix(cfg: ModelConfig, streams: int, seed: int) -> np.ndarray:
    """Each stream's side input as the client holds it: a VLM's image,
    ``[streams, n_frontend_tokens, d]`` float32 patch embeddings, or an
    audio model's ``[streams, encoder_len, d]`` frame embeddings; normal x
    0.02, the stub ``TokenPipeline`` draws for batch 0 of ``streams``
    sequences with ``seed``."""
    shape = ShapeConfig(name="client_prefix",
                        seq_len=cfg.n_frontend_tokens + 1,
                        global_batch=streams, kind="prefill")
    return TokenPipeline(cfg, shape, seed=seed).stub(0)


def resolve_arch(arch: str, smoke: bool = False) -> ModelConfig:
    return PI_LM if arch == PI_LM.name else get_arch(arch, smoke=smoke)


def run(device: Device = None, arch: str = PI_LM.name, *, smoke: bool = False,
        tokens: int = 8, streams: int = 2,
        prompt: Optional[np.ndarray] = None, seed: int = 0,
        prefix: Optional[np.ndarray] = None,
        model: Optional[Model] = None, verbose: bool = True) -> dict:
    """Generate ``tokens`` tokens for each of ``streams`` streams with every
    embedding retrieved privately, and check the rows and tokens (raises
    ``AssertionError`` on a mismatch). ``model`` (with its weights, on its
    device) replaces the one drawn from ``seed`` for ``arch``; ``prompt``
    ``[streams, T]`` replaces the example's. ``prefix`` ``[streams, P,
    d]`` is the client's side input (:func:`side_input`: a VLM's rows
    ahead of the prompt, an audio model's frames), never sent; a family
    that takes one gets :func:`client_prefix` without it. Returns what
    happened, the kernel counters included."""
    say = print if verbose else (lambda *a: None)
    if model is None:
        dev = resolve_device(device)
        model = build_model(resolve_arch(arch, smoke), device=dev)
        model.init_params(torch.Generator(dev).manual_seed(seed))
    dev = model.device
    cfg = model.cfg
    prompt = example_prompt(streams) if prompt is None else np.asarray(prompt)
    prompt_t = torch.as_tensor(prompt, dtype=torch.int64, device=dev)
    if prefix is None and side_input(cfg) is not None:
        prefix = client_prefix(cfg, prompt.shape[0], seed)
    prefix_t = (None if prefix is None else
                torch.as_tensor(prefix, device=dev).to(cfg.torch_dtype))
    ops.reset_counts()
    t0 = time.perf_counter()
    private = PrivateEmbedding(model, client_rng=np.random.default_rng(
        seed + 1))
    _sync(dev)
    setup_s = time.perf_counter() - t0
    n_prefix = 0 if prefix_t is None else prefix_t.shape[1]
    say(f"{cfg.name}: {cfg.n_layers} layers x d_model {cfg.d_model}; PIR "
        f"table {private.pir_cfg.n_items} rows x {private.pir_cfg.item_bytes}"
        f" B on {dev}; {n_prefix} client-side rows a stream")
    gen = generate(model, private, prompt_t, tokens, prefix_t)
    solo = solo_step(model, private, gen)
    counts = ops.counts()
    rows_exact = private.check_rows()

    plain = lambda ids: embed_lookup(model.embed, ids.to(dev))
    gen_plain = generate(model, plain, prompt_t, tokens, prefix_t)
    solo_plain = solo_step(model, plain, gen_plain)
    streams_out = gen["tokens"].tolist()
    same = (torch.equal(gen["tokens"], gen_plain["tokens"])
            and solo == solo_plain)
    for step, row in enumerate(gen["tokens"][:, prompt.shape[1]:].T):
        say(f"step {step}: +{row.tolist()}")
    say(f"generated streams:\n{np.asarray(streams_out)}")
    if not rows_exact:
        raise AssertionError("a privately retrieved row differs from the "
                             "table's")
    if not same:
        raise AssertionError(
            f"private lookups generated {streams_out} + [{solo}], plain "
            f"lookups {gen_plain['tokens'].tolist()} + [{solo_plain}]")
    lookups = private.log
    n_queries = sum(len(e["ids"]) for e in lookups)
    say(f"PIR-backed lookups were bit-exact; {n_queries} private queries in "
        f"{len(lookups)} calls.")
    steps = gen["steps"]
    return {
        "twin": "private_inference", "arch": cfg.name, "device": str(dev),
        "streams": streams_out, "solo_token": solo,
        "rows_exact": rows_exact, "plain_equal": same,
        "queries": n_queries, "prefix_rows": n_prefix,
        "pir_calls": [{"queries": len(e["ids"]), "seconds": e["seconds"]}
                      for e in lookups],
        "steps": steps, "setup_s": setup_s,
        "buckets": list(private.system.servers[0].buckets),
        "launches": {k: v["launches"] for k, v in counts.items()},
        "plain_calls": {k: v["plain_calls"] for k, v in counts.items()}}


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--arch", default=PI_LM.name,
                    help="pi-lm (the example's model) or a dense, moe, "
                    "vlm, audio, ssm or hybrid arch")
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's reduced config")
    ap.add_argument("--tokens", type=int, default=8)
    ap.add_argument("--streams", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    out = run(device=args.device, arch=args.arch, smoke=args.smoke,
              tokens=args.tokens, streams=args.streams, seed=args.seed)
    out.pop("steps")
    out.pop("pir_calls")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
