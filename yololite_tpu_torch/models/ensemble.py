"""Model ensembling: decoded candidates of several checkpoints concatenated before one NMS.

Port of yololite_tpu/models/ensemble.py: each member decodes to (boxes,
scores) and the candidates concatenate along the anchors before the shared
NMS (the "NMS ensemble" of a pickled upstream Ensemble).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from yololite_tpu_torch.models.checkpoint import attempt_load_one_weight
from yololite_tpu_torch.ops.nms import non_max_suppression
from yololite_tpu_torch.utils import LOGGER


class Ensemble:
    """Holds several member models; callable like one model on NHWC float images."""

    def __init__(self):
        self.members: List = []

    def append(self, model):
        self.members.append(model)

    @property
    def names(self):
        return self.members[0].names

    def decode(self, images: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Run every member (eval mode) and concatenate (boxes, scores) along the anchors."""
        from yololite_tpu_torch.models.model import EnsembleModel

        em = EnsembleModel(self.members)
        was = [m.training for m in self.members]
        em.eval()
        try:
            with torch.no_grad():
                return em.decode_concat(images, half=False)
        finally:
            for m, t in zip(self.members, was):
                m.train(t)

    def __call__(self, images, conf_thres=0.25, iou_thres=0.45, max_det=300):
        boxes, scores = self.decode(images)
        return non_max_suppression(boxes, scores, conf_thres=conf_thres, iou_thres=iou_thres, max_det=max_det)


def attempt_load_weights(weights: Sequence[str], nc: Optional[int] = None) -> Ensemble:
    """Load one or more checkpoints (.pt or .npz) into an Ensemble."""
    ens = Ensemble()
    for w in [weights] if isinstance(weights, str) else list(weights):
        model, _ = attempt_load_one_weight(w, nc=nc)
        ens.append(model)
    if len(ens.members) > 1:
        LOGGER.info(f"Ensemble of {len(ens.members)} models created")
    return ens
