"""The port's plan layer, core half: the paper's contribution as a
composable library (a copy of ``repro/core``).

Semantic operators (paper Table 1), MODEL/PROMPT resources (§2.1) and the
seamless optimizations (§2.3): meta-prompting, adaptive batching, caching,
dedup — plus fusion for hybrid search.  ``LocalTorchProvider`` stands
where the reference exports ``LocalJaxProvider``; ``ProviderStats`` is
exported too.  The engine half (``Pipeline``, optimizer, analyzer) is
``repro_torch.engine``.
"""

from .batching import (BatchPlan, BatchStats, ContextOverflowError,
                       plan_batches)
from .cache import (CalibrationStore, IndexStore, PredictionCache,
                    SelectivityStore, bound_observations, cache_key,
                    corpus_fingerprint, headroom_factor)
from .fusion import (FUSION_METHODS, combanz, combmed, combmnz, combsum,
                     fusion, max_normalize, rrf)
from .functions import (ExecutionReport, SemanticContext, llm_complete,
                        llm_complete_json, llm_embedding, llm_filter,
                        llm_first, llm_last, llm_multi, llm_reduce,
                        llm_reduce_json, llm_rerank)
from .metaprompt import (MetaPrompt, build_metaprompt, build_multi_task,
                         build_prefix, serialize_batch, serialize_tuple)
from .provider import (BaseProvider, LocalTorchProvider, MockProvider,
                       ProviderStats, estimate_tokens)
from .resources import (Catalog, ModelResource, PromptResource,
                        reset_global_catalog)
from .scheduler import (DispatchJob, RequestScheduler, SchedulerStats,
                        SpecTask, SpeculativeJoin, SpeculativeMaskJoin,
                        execute_serial, split_batch)
