"""delay_enc_tpu_torch — the PyTorch and CUDA port of delay_enc_tpu.

The same proving framework (delay-encryption / PVDE circuits in a
halo2-style PLONK proof system with KZG commitments on BN254), running on
an NVIDIA H100 instead of a TPU.  It imports torch, numpy and the standard
library, never jax and nothing of `delay_enc_tpu`:

 - ``fields``, ``curves``, ``poseidon``, ``encryption``, ``cs``,
   ``gadgets``, ``models``, ``native``, ``plonk.transcript``,
   ``plonk.verifier``, ``utils.config``: host layers copied from the JAX
   package;
 - ``ops``       field arithmetic, NTT and MSM on word tensors, each
                 hand-written CUDA kernel (``csrc/``) beside its plain
                 PyTorch version;
 - ``plonk``     SRS, keygen, create_proof (fused 8n quotient path) and
                 verify;
 - ``state``     conversions from the JAX package's arrays.

Entry points run on the card (``device="cuda"``) unless given
``device="cpu"``, where every kernel is replaced by its plain version.
"""

__version__ = "0.1.0"
