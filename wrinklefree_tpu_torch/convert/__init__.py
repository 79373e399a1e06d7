"""Weight conversion and the packed cache (PyTorch port of
``wrinklefree_tpu/convert``), on the standard library and numpy."""

from .cache_key import PACK_FORMAT, compute_cache_key
from .convert import convert_and_save
from .gguf import convert_hf_to_gguf, read_gguf, validate_gguf, write_gguf
from .loader import get_cached_or_convert, list_cached_models
