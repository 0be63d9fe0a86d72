from .pose_enc import PoseidonEncCircuit
from .mod_pow import RSACircuit
from .delay_enc import DelayEncryptCircuit
