from .transcript import Transcript
from .domain import Domain
from .kzg import SRS
from .keygen import keygen, ProvingKey, VerifyingKey
from .prover import create_proof
from .batch_prover import create_proofs_batched
from .pipeline import create_proofs_pipelined
from .verifier import verify_proof, verify_proofs_batched
from .serialize import save_pk, load_pk, save_vk, load_vk
