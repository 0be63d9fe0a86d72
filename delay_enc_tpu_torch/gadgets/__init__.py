from .poseidon_chip import PoseidonChip
from .hasher import HasherChip
from .enc_chip import PoseidonEncChip
