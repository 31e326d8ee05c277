"""ray_tpu_torch.parallel — the parallel layer of the port. So far it holds
only ``quant``, the block-scaled wire codecs the compiled-graph channels
use; the mesh, collective and ZeRO layers are not ported yet."""
