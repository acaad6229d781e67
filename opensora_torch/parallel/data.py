"""Global batch placement over the ranks of a mesh (counterpart of
opensora_tpu/parallel/data.py:21-76).

JAX places a host batch as global arrays laid out over the mesh: rows on
'data', the token dim of the token tensors on 'sp'. The counterpart here is
:class:`Placed`: one global batch entry cut into one piece per rank, each
on its rank's device, with the spec that cut it. A data rank reads its
whole rows back with :meth:`Placed.rows`.

The MMDiT's sequence-parallel forward does not keep this cut: its sp ranks
hold chunks of the joint [txt, img] sequence (:func:`joint_chunks`, the one
place that layout is defined), which the model cuts from a data rank's
whole rows (``MMDiTModel.forward_rank``). The trainer hands it those rows,
since the loss's interpolation and target are taken over them, so a
batch entry's per-key cut over 'sp' is JAX's placement of the batch and
no more.

Over processes (a mesh whose 'data' and 'sp' axes may cross them) each
process gives the rows of its 'data' coordinates, as
``jax.make_array_from_process_local_data`` takes a host's
(opensora_tpu/parallel/data.py:52-73): the processes of one data block (the
same data coordinates, other sp ranks: ``Mesh.data_block``) give the same
rows, read from the same samples (:func:`data_replicas`); the global batch
is the blocks' rows joined in block order, and a process holds the pieces
of its own ranks only (None for the others'). The processes' batches must
have the same shapes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

from opensora_torch.parallel import distributed
from opensora_torch.parallel.comm import process_all_gather
from opensora_torch.parallel.mesh import DATA_AXIS, SP_AXIS, Mesh
from opensora_torch.parallel.sharding import constrain

# batch entries whose dim 1 is the token axis (cut over 'sp')
TOKEN_KEYS = frozenset({"x0", "img_ids", "txt", "txt_ids", "cond", "null_txt"})


def row_slice(n_rows: int, dp: int, d: int) -> slice:
    """The rows of data rank ``d`` of ``dp`` in a batch of ``n_rows``."""
    per = n_rows // dp
    return slice(d * per, (d + 1) * per)


def joint_chunks(n_txt: int, n_img: int, sp: int) -> List[Tuple[slice, slice]]:
    """The sequence-parallel layout of the MMDiT's tokens: sp rank s holds
    the joint [txt, img] tokens [s L / sp, (s + 1) L / sp), L = n_txt +
    n_img, as JAX's attention under SP sees the joint sequence
    (opensora_tpu/ops/sp.py:55, :111). Per rank, (its slice of the text
    tokens, its slice of the image tokens); either may be empty. L must
    divide by sp (``seq_align`` pads the text so that it does)."""
    total = n_txt + n_img
    if total % sp:
        raise ValueError(f"{total} joint tokens do not split over sp {sp}")
    per = total // sp
    out = []
    for s in range(sp):
        lo, hi = s * per, (s + 1) * per
        out.append((slice(min(lo, n_txt), min(hi, n_txt)), slice(max(lo - n_txt, 0), max(hi - n_txt, 0))))
    return out


def data_replicas(mesh: Optional[Mesh]) -> Dict[str, int]:
    """The sampler's ``num_replicas`` and ``rank`` over ``mesh``: its data
    blocks and this process's (every process of one data block reads the
    same samples); without a mesh, the processes of the run."""
    if mesh is None:
        return dict(num_replicas=distributed.process_count(), rank=distributed.process_index())
    return dict(num_replicas=mesh.data_blocks, rank=mesh.data_block)


def batch_sharding(mesh: Mesh, key: str, shape) -> Tuple[Optional[str], ...]:
    """The spec of one batch entry: rows on 'data'; the token dim on 'sp'
    when the key is a token tensor and its length divides the sp axis
    (``seq_align`` sees to it for the text; image tokens that do not divide
    stay whole on every sp rank: correct, only less cut)."""
    spec = (DATA_AXIS, SP_AXIS if key in TOKEN_KEYS else None, *[None] * (len(shape) - 2))[:len(shape)]
    return (DATA_AXIS,) + constrain(shape, spec, mesh)[1:]


@dataclass
class Placed:
    """A global tensor (of ``shape``) cut over ``mesh``: ``shards[r]`` is
    rank r's piece, on its device (None where another process holds the
    rank); ``whole[d]`` data rank d's rows (of this process's data
    coordinates), whole along every other dim."""

    mesh: Mesh
    spec: Tuple[Optional[str], ...]
    shards: List[Optional[torch.Tensor]]
    shape: torch.Size
    whole: Dict[int, torch.Tensor]

    @property
    def device(self) -> torch.device:
        return self.shards[self.mesh.local_ranks[0]].device

    def rows(self, d: int) -> torch.Tensor:
        """Data rank ``d``'s rows (a rank of this process), on the device
        of its first rank here ((d, 0, 0) in one process)."""
        return self.whole[d]

    def full(self, device=None) -> torch.Tensor:
        """The global tensor on ``device`` (default: the first local
        rank's); over processes, gathered from the other data blocks (a
        collective of this process's 'data' group)."""
        device = device or self.device
        mine = torch.cat([self.rows(d).to(device) for d in self.mesh.local_data], 0)
        if self.mesh.data_blocks == 1:
            return mine
        return process_all_gather(mine, 0, self.mesh.process_group(DATA_AXIS, self.mesh.local_ranks[0]))


def place(mesh: Mesh, key: str, x: torch.Tensor) -> Placed:
    """``x`` (this process's rows of the global batch) cut by
    :func:`batch_sharding`, one piece per rank of this process on its
    device."""
    spec = batch_sharding(mesh, key, x.shape)
    sp, local = mesh.shape[SP_AXIS], mesh.local_data
    shards: List[Optional[torch.Tensor]] = []
    whole: Dict[int, torch.Tensor] = {}
    for r, dev in enumerate(mesh.devices):
        if not mesh.is_local(r):
            shards.append(None)
            continue
        d, s, _ = mesh.coords(r)
        piece = x[row_slice(x.shape[0], len(local), local.index(d))]
        whole.setdefault(d, piece.to(dev))
        if SP_AXIS in spec:
            piece = piece.chunk(sp, 1)[s]
        shards.append(piece.to(dev))
    return Placed(mesh, spec, shards, torch.Size((x.shape[0] * mesh.data_blocks, *x.shape[1:])), whole)


def make_global_batch(mesh: Mesh, batch: Dict[str, Optional[torch.Tensor]]) -> Dict[str, Optional[Placed]]:
    """Place a batch dict on the mesh (None stays None): over processes,
    each process's entries are its data block's rows. A global batch whose
    rows do not divide over 'data' raises, with the JAX package's message,
    and so do processes whose batches differ in shape."""
    dp = mesh.shape[DATA_AXIS]
    batch = {k: None if v is None else torch.as_tensor(v) for k, v in batch.items()}
    if mesh.n_processes > 1:
        shapes = {k: None if v is None else tuple(v.shape) for k, v in batch.items()}
        every = distributed.all_gather_object(shapes)
        if any(s != shapes for s in every):
            raise ValueError(f"the processes' batches differ in shape: {every}; every process must give rows of "
                             f"the same shapes (one bucket a step)")
    out: Dict[str, Optional[Placed]] = {}
    for key, val in batch.items():
        if val is None:
            out[key] = None
            continue
        b_global = val.shape[0] * mesh.data_blocks
        if b_global % dp != 0:
            raise ValueError(
                f"global batch {b_global} (key {key!r}) not divisible by the "
                f"mesh 'data' axis ({dp}); set each bucket's batch size to a "
                f"multiple of dp (configs bucket_config) or shrink dp_size"
            )
        out[key] = place(mesh, key, val)
    return out
