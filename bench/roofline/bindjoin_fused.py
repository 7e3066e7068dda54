"""The fused bind-join kernel (``bindjoin_fused_kernel``): the grouped
kernel over pages of several segments, each page against its own
segment's slot table and base vector."""
from .common import facts, work  # noqa: F401  (the file's interface)

# the wrapper in repro_torch.kernels.ops, and what the device records of
# its kernel are named
WRAPPER = "bindjoin_fused_cuda"
DEVICE_NAME = "bindjoin_fused"
