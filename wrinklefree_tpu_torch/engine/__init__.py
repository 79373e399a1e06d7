from .engine import Engine, Request
from .page_allocator import PageAllocator
from .radix_cache import RadixCache
from .sampling_params import SamplingParams
