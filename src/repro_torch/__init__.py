"""IM-PIR on PyTorch + CUDA: the port of ``repro`` to an NVIDIA H100.

The package mirrors ``repro``'s module names so each counterpart is easy
to find (``repro_torch/core/dpf.py`` <-> ``repro/core/dpf.py``), but it
imports neither JAX nor anything of ``repro``: only the tests import both.

Ported so far, served end to end on one device: the multi-server
schemes — the paper's two-server XOR scheme (``xor-dpf-2``), two-server
additive Z_256 shares (``additive-dpf-2``) and k-server XOR
(``xor-dpf-k``) — and the single-server LWE scheme (``lwe-simple-1``),
with every TPU kernel of the reference rewritten as hand-written CUDA C++
for Hopper (``csrc/``):

  kernels/dpxor.py       select-XOR scan             (csrc/dpxor.cu)
  kernels/fused_scan.py  fused GGM-expand + XOR scan (csrc/fused_scan_xor.cu)
                         fused GGM-expand + add scan (csrc/fused_scan_add.cu)
  kernels/pir_matmul.py  int8 GEMM                   (csrc/pir_gemm.cu)
  kernels/lwe_matmul.py  wrapping int32 GEMM         (csrc/lwe_gemm.cu)
  kernels/ggm_expand.py  one corrected GGM level     (csrc/ggm_expand.cu)

The engine plane (``engine/``) picks each batch bucket's plan: a measured
tuner on the card and a plan cache keyed by the card's name, falling back
to ``core.protocol.plan_for``. The database plane (``db/``) takes online
updates (``stage`` / ``publish``: epochs, copy-on-publish, the LWE hint's
exact delta on the int32 GEMM), and the batch plane (``core/batch.py``,
``db/bucketed.py``, ``runtime/batch.BatchPIR``) serves m records per
round over cuckoo buckets.

The LM side serves and trains the dense family: ``models/``
(``TransformerLM``, an ``nn.Module`` with prefill, KV-cached decode and a
next-token loss with per-block recomputation; plain PyTorch, as the
reference computes it outside any Pallas kernel), ``configs/`` (the four
dense architectures), ``runtime/steps.make_serve_step`` and
``make_train_step``, the train half's ``optim/`` (AdamW, Adafactor, int8
gradient compression with error feedback), ``data/`` (the synthetic token
pipeline), ``checkpoint/`` and ``runtime/train_loop.TrainLoop``
(``python -m repro_torch.launch.train``, ``python -m
repro_torch.train_lm``), and ``private_inference`` (the paper's
ML-inference use case: every token's embedding retrieved through
``TwoServerPIR``).

Entry points (``runtime.serve_loop.TwoServerPIR``, ``MultiServerPIR``,
``SingleServerPIR``, ``runtime.batch.BatchPIR``, ``core.server.PIRServer``,
``kernels.ops``, ``models.build_model``, ``runtime.steps.make_train_step``,
``runtime.train_loop.TrainLoop``) run on
the card unless the caller passes ``device="cpu"``;
without a card they raise instead of falling back. Run the quickstart twin
with ``python -m repro_torch.quickstart`` (and the updates and batch twins
with ``python -m repro_torch.db_updates`` / ``.batch_query``).

Integer words: torch has no CPU arithmetic for ``uint32``, so every u32
quantity of the reference (DB words, seeds, bits) is carried as ``int32``
with the same bit pattern. Add, xor, and and left shift wrap identically;
right shifts are masked (``crypto/chacha.py``). ``convert`` moves numpy
``uint32`` arrays in and out.
"""
