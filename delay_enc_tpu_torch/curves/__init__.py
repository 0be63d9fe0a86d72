from .bn254 import G1, G2, G1_GEN, G2_GEN
from .pairing import pairing, multi_pairing
