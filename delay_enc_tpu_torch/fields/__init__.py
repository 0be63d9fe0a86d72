from .bn254 import FQ, FR, Fp as BN254Fq, Fr as BN254Fr
from .pasta import PASTA_FP, PASTA_FQ
from .prime import PrimeField
