"""The learned latent codes of the auto-decoder (counterpart of
``aonerf.models.codes``).

  - shape and appearance tables: (n_max_objs, obj_code_dim), xavier uniform
  - articulation table: (n_max_articulations, art_code_dim), xavier uniform
  - the test-time articulation sweep: 2N-1 codes, the learned ones at even
    slots and the midpoints of their neighbours at odd slots
"""

from typing import Dict, Optional

import torch
from torch import nn

from aonerf_torch import DeviceLike, default_device


class CodeLibraryArticulated(nn.Module):
    def __init__(
        self,
        n_max_objs: int = 4,
        obj_code_dim: int = 128,
        n_max_articulations: int = 10,
        art_code_dim: int = 32,
        generator: Optional[torch.Generator] = None,
        device: DeviceLike = None,
    ):
        """Tables drawn on the CPU from ``generator``, then moved to
        ``device``."""
        super().__init__()
        self.n_max_articulations, self.art_code_dim = n_max_articulations, art_code_dim
        self.embedding_instance_shape = nn.Embedding(n_max_objs, obj_code_dim, device="meta")
        self.embedding_instance_appearance = nn.Embedding(n_max_objs, obj_code_dim, device="meta")
        self.embedding_instance_articulation = nn.Embedding(n_max_articulations, art_code_dim, device="meta")
        self.to_empty(device="cpu")
        with torch.no_grad():
            for table in self.children():
                nn.init.xavier_uniform_(table.weight, generator=generator)
        self.to(default_device(device))

    def forward(self, instance_id, articulation_id, is_test: bool = False) -> Dict[str, torch.Tensor]:
        """The codes of ids (int, 0-d or (B,) tensors): 'density' (shape),
        'color' (appearance) and 'articulation'. With ``is_test`` the
        articulation id indexes the interpolated sweep."""
        dev = self.embedding_instance_shape.weight.device
        instance_id = torch.as_tensor(instance_id, device=dev)
        articulation_id = torch.as_tensor(articulation_id, device=dev)
        ret = {
            "density": self.embedding_instance_shape(instance_id),
            "color": self.embedding_instance_appearance(instance_id),
        }
        if is_test:
            ret["articulation"] = self.get_interpolated_articulations()[articulation_id]
        else:
            ret["articulation"] = self.embedding_instance_articulation(articulation_id)
        return ret

    def get_interpolated_articulations(self, max_interpolations: int = 2) -> torch.Tensor:
        """(2N-1, art_code_dim): the learned codes at even indices, the
        midpoints of neighbours at odd indices."""
        if max_interpolations != 2:
            raise NotImplementedError("only midpoints are defined")
        table = self.embedding_instance_articulation.weight
        mids = 0.5 * (table[:-1] + table[1:])
        pairs = torch.stack([table[:-1], mids], dim=1).reshape(-1, self.art_code_dim)
        return torch.cat([pairs, table[-1:]], dim=0)
