"""The FL split models: VGG-11 and the MLP as slot-batched layer lists."""
