from .store import VecStore
from .flat import FlatIndex
from .pq_table import PQTable
from .ivf import IVFIndex
from .hnsw import HNSWIndex
from .kmeans import KMeans
from .u8 import U8VecSet, FlatIndexU8
from . import base, native

__all__ = [
    "VecStore",
    "FlatIndex",
    "PQTable",
    "IVFIndex",
    "HNSWIndex",
    "KMeans",
    "U8VecSet",
    "FlatIndexU8",
    "base",
    "native",
]
