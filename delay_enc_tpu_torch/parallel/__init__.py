"""Proving over a mesh of shards: the counterpart of `delay_enc_tpu/parallel/`.

 - ``mesh``   a `Mesh` of torch devices (`make_mesh`, `Mesh.shared`) and the
              exchanges between its shards;
 - ``ntt``    the sharded NTT and its inverse, with kernel K12's stages and
              reshuffle, which read the shards' blocks in place;
 - ``msm``    the MSM with points and scalars split over the shards;
 - ``batch``  batch commitments with the instance axis split over the shards;
 - ``dryrun`` `dryrun_multichip`, every path once over a mesh, checked.

`plonk.create_proofs_batched(..., mesh=)` splits a batch of proofs the same
way.
"""

from .mesh import Mesh, make_mesh
from .msm import sharded_msm, sharded_plane_sums
from .ntt import ShardedNTTPlan, sharded_intt, sharded_ntt
from .batch import batch_commit
from .dryrun import dryrun_multichip
