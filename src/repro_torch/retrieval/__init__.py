from .bm25 import BM25Index, tokenize
from .ivf import IVFIndex
from .vector import VectorIndex, active_mesh, cosine_topk, ensure_index
