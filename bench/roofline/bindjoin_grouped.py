"""The grouped bind-join kernel (``bindjoin_grouped_kernel``): one
pattern's groups over a chunk of window pages of every shard."""
from .common import facts, work  # noqa: F401  (the file's interface)

# the wrapper in repro_torch.kernels.ops, and what the device records of
# its kernel are named
WRAPPER = "bindjoin_grouped_cuda"
DEVICE_NAME = "bindjoin_grouped"
