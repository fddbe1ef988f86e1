"""The paper's quantizer module inside training and serving, in torch:
gradient all-reduce compression, optimizer-moment compression, KV-cache
quantization."""
from . import grad, kvcache, opt_state  # noqa: F401
