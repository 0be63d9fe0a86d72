from .grain import grain_generate
from .spec import Spec, SparseMDS, spec as get_spec
from .sponge import Poseidon
