"""Models: the LM stack's bundles (``get_bundle``) and the FL split models
(VGG-11, the MLP and the token models as slot-batched layer lists)."""
from repro_torch.models.registry import (ModelBundle, bundle_for, demo_batch,
                                         get_bundle)

__all__ = ["ModelBundle", "bundle_for", "get_bundle", "demo_batch"]
