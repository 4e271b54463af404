"""The port's copy of what the model boundary needs from ``repro.core``:
providers, meta-prompts, the MODEL resource and the context-window error.
The plan layer (semantic functions, scheduler, caches) is the next slice."""

from .batching import ContextOverflowError
from .metaprompt import (MetaPrompt, build_metaprompt, build_prefix,
                         serialize_batch, serialize_tuple)
from .provider import (BaseProvider, LocalTorchProvider, ProviderStats,
                       estimate_tokens)
from .resources import ModelResource
