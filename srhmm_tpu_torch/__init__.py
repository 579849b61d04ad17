"""srhmm_tpu_torch — the PyTorch + CUDA port of ``srhmm_tpu``.

Continuous-density GMM-HMM isolated-word recognition and training,
continuous word-loop decoding, embedded / tied-state training over
transcript-composed chains, the MFCC frontend and the end-to-end
pipeline, on an NVIDIA Hopper GPU.  The package
mirrors ``srhmm_tpu``'s layout and names so each module's counterpart is
easy to find; it imports torch and numpy, never jax.

Package map:
  features/      MFCC / log-mel frontend, deltas, CMVN
  io/            .perfil / .hmm codecs (byte-compatible), padded batching
  models/        GmmStream / GmmHmm modules, vocab stacking, tied senone
                 sets and decision-tree tying, weight exchange with the JAX
                 package (convert.py)
  ops/           emission log-likelihoods, forward recursions, Viterbi
  ops/kernels/   hand-written CUDA kernels, their plain PyTorch twins and
                 the nvcc build (csrc/ holds the sources)
  decode/        isolated-word scoring and ranking; continuous word-loop
                 decoding (unigram / bigram LM, N-best, forced-alignment
                 graphs)
  train/         Baum-Welch EM: reference-exact, batched isolated-word,
                 embedded (unit inventory) and tied (senone inventory)
  eval/          accuracy metrics + reference-format report writer
  pipeline.py    synthetic audio -> MFCC -> monophone / tied EM -> decode
                 -> WER as one call
  cli/           the recognize and train entry points (reference argv
                 contract), decode, align, train_embedded, features and
                 pipeline (the JAX CLIs' contract)

Precision is always explicit: float64 parity paths ask for float64, the GPU
fast path for float32.  The default dtype is never changed.
"""

__version__ = "0.1.0"
