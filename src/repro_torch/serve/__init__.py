"""Serving: the dense-cache and paged-KV continuous-batching engines, the
prefix-affinity router and the open-loop traffic generator."""
from .engine import (PromptTooLongError, Request, ServeConfig, ServingEngine,
                     prefix_key, validate_prompt)
from .paged import (BlockAllocator, BlockLeakError, PagedServeConfig,
                    PagedServingEngine, kv_token_bytes, max_block_tokens)
from .router import PrefixRouter

__all__ = ["PromptTooLongError", "Request", "ServeConfig", "ServingEngine",
           "prefix_key", "validate_prompt", "BlockAllocator",
           "BlockLeakError", "PagedServeConfig", "PagedServingEngine",
           "kv_token_bytes", "max_block_tokens", "PrefixRouter"]
