"""Pasta curve fields (Fp of Pallas, Fq of Pallas = Fp of Vesta).

The reference runs its big-integer gadget tests over pasta Fp/Fq in addition
to bn256 (reference/src/big_integer/chip.rs:1470-1474); the gadget
layer here is field-agnostic in the same way, so these parameters are used by
the multi-field gadget tests.
"""

from .prime import PrimeField

PASTA_FP_MOD = 0x40000000000000000000000000000000224698FC094CF91B992D30ED00000001
PASTA_FQ_MOD = 0x40000000000000000000000000000000224698FC0994A8DD8C46EB2100000001

# pasta_curves: Fp generator = 5, Fq generator = 5
PASTA_FP = PrimeField("pasta::Fp", PASTA_FP_MOD, generator=5)
PASTA_FQ = PrimeField("pasta::Fq", PASTA_FQ_MOD, generator=5)
