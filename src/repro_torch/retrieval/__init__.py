from .vector import VectorIndex, cosine_topk
