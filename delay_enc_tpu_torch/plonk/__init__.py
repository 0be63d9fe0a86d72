from .transcript import Transcript
from .domain import Domain
from .kzg import SRS
from .keygen import keygen, ProvingKey, VerifyingKey
from .prover import create_proof
from .verifier import verify_proof, verify_proofs_batched
