"""Binary indexed datasets, byte-compatible with the fork's formats.

The port's own copy of ``fbk_fairseq_st_tpu/data/indexed_dataset.py``
(``load_indexed_dataset`` :133, ``IndexedDataset`` :176,
``FilterBanksDataset`` :254, ``IndexedDatasetBuilder`` :295,
``AudioIndexedDatasetBuilder`` :351, ``MMapIndexedDataset`` :361,
``MMapIndexedDatasetBuilder`` :435, ``best_fitting_dtype`` :76,
``make_builder`` :109, both builders' ``merge_file_`` :324, :446; reference
fairseq/data/indexed_dataset.py). Two on-disk formats of ``<prefix>.bin`` +
``<prefix>.idx``:

TNT ("lazy"/"cached"):
    idx:  b'TNTIDX\\x00\\x00' | <Q version=1 | <QQ dtype_code,element_size
          | <QQ n_items, n_sizes | int64[n+1] dim_offsets
          | int64[n+1] data_offsets (in elements) | int64[n_sizes] sizes
    bin:  the raw C-order element stream. Item i's shape is
          ``sizes[dim_offsets[i]:dim_offsets[i+1]]``: the 2-D float32
          filterbanks are stored so. The token builder adds 1 to every
          value (the Lua convention) and token readers subtract it
          (``fix_lua_indexing``); the audio builder stores values as they
          are.

MMap:
    idx:  b'MMIDIDX\\x00\\x00' | <Q version=1 | <B dtype_code | <Q n
          | int32[n] sizes | int64[n] pointers (byte offsets)
    bin:  the raw C-order element stream.

Items are numpy arrays, read on the host.
"""

from __future__ import annotations

import itertools
import os
import shutil
import struct
from functools import lru_cache
from typing import Optional

import numpy as np

_TNT_MAGIC = b"TNTIDX\x00\x00"
_MMAP_MAGIC = b"MMIDIDX\x00\x00"

# dtype codes shared by both formats (reference indexed_dataset.py:83-92)
DTYPES = {1: np.uint8, 2: np.int8, 3: np.int16, 4: np.int32, 5: np.int64, 6: np.float64, 7: np.float64,
          8: np.float32}


def dtype_code(dtype) -> int:
    for k, v in DTYPES.items():
        if v == dtype:
            return k
    raise ValueError(dtype)


def best_fitting_dtype(vocab_size: Optional[int] = None):
    """int32 at any vocabulary size, as JAX: the reference picks uint16 for
    small vocabularies (indexed_dataset.py:17-21), a type without a code in
    its own table, so such a file could not be read back."""
    return np.int32


def make_builder(out_file: str, impl: str, vocab_size: Optional[int] = None):
    """The mmap builder for ``mmap``, the TNT token builder for every other
    ``--dataset-impl`` (``raw``, ``lazy``, ``cached``), as JAX."""
    if impl == "mmap":
        return MMapIndexedDatasetBuilder(out_file, dtype=best_fitting_dtype(vocab_size))
    return IndexedDatasetBuilder(out_file)


def index_file_path(prefix_path: str) -> str:
    return prefix_path + ".idx"


def data_file_path(prefix_path: str) -> str:
    return prefix_path + ".bin"


def infer_dataset_impl(path: str) -> Optional[str]:
    if IndexedRawTextDataset.exists(path):
        return "raw"
    if IndexedDataset.exists(path):
        with open(index_file_path(path), "rb") as f:
            magic = f.read(8)
        if magic == _TNT_MAGIC:
            return "cached"
        if magic == _MMAP_MAGIC[:8]:
            return "mmap"
    return None


def make_dataset(path: str, impl: str, fix_lua_indexing: bool = False, dictionary=None):
    if impl == "raw" and IndexedRawTextDataset.exists(path):
        assert dictionary is not None
        return IndexedRawTextDataset(path, dictionary)
    if impl in ("lazy", "cached") and IndexedDataset.exists(path):
        return IndexedDataset(path, fix_lua_indexing=fix_lua_indexing)
    if impl == "mmap" and MMapIndexedDataset.exists(path):
        return MMapIndexedDataset(path)
    return None


def load_indexed_dataset(path: str, dictionary=None, dataset_impl=None, combine: bool = False,
                         default: str = "cached"):
    """The dataset at ``path`` (and with ``combine`` its ``path1``,
    ``path2``, ... shards, concatenated), or None; token TNT datasets are
    read with ``fix_lua_indexing`` (reference data_utils.py:51-96)."""
    datasets = []
    for k in itertools.count():
        path_k = path + (str(k) if k > 0 else "")
        impl = dataset_impl or infer_dataset_impl(path_k) or default
        ds = make_dataset(path_k, impl, fix_lua_indexing=True, dictionary=dictionary)
        if ds is None:
            if k > 0:
                break
            return None
        datasets.append(ds)
        if not combine:
            break
    if len(datasets) == 1:
        return datasets[0]
    from .datasets import ConcatDataset

    return ConcatDataset(datasets)


def dataset_exists(path: str, impl: Optional[str]) -> bool:
    if impl == "raw":
        return IndexedRawTextDataset.exists(path)
    if impl is None:
        return IndexedDataset.exists(path) or IndexedRawTextDataset.exists(path)
    return IndexedDataset.exists(path)


class IndexedDataset:
    """Reader of the TNT format (token datasets give int64 arrays)."""

    def __init__(self, path: str, fix_lua_indexing: bool = False):
        self.path = path
        self.fix_lua_indexing = fix_lua_indexing
        self._mmap = None
        with open(index_file_path(path), "rb") as f:
            if f.read(8) != _TNT_MAGIC:
                raise ValueError("Index file doesn't match expected format (TNTIDX).")
            if struct.unpack("<Q", f.read(8)) != (1,):
                raise ValueError("unknown TNT index version")
            code, self.element_size = struct.unpack("<QQ", f.read(16))
            self.dtype = DTYPES[code]
            self._len, self.s = struct.unpack("<QQ", f.read(16))
            self.dim_offsets = np.fromfile(f, dtype=np.int64, count=self._len + 1)
            self.data_offsets = np.fromfile(f, dtype=np.int64, count=self._len + 1)
            self.sizes = np.fromfile(f, dtype=np.int64, count=self.s)

    def _data(self) -> np.memmap:
        if self._mmap is None:
            self._mmap = np.memmap(data_file_path(self.path), mode="r", dtype=self.dtype)
        return self._mmap

    def check_index(self, i: int) -> None:
        if i < 0 or i >= self._len:
            raise IndexError("index out of range")

    def _read(self, i: int) -> np.ndarray:
        self.check_index(i)
        shape = tuple(self.sizes[self.dim_offsets[i]: self.dim_offsets[i + 1]])
        start = self.data_offsets[i]
        return np.array(self._data()[start: start + int(np.prod(shape))]).reshape(shape)

    def __getitem__(self, i: int) -> np.ndarray:
        # a copy: a consumer's in-place op must not reach the cached item
        return self._cached_item(i).copy()

    @lru_cache(maxsize=8)
    def _cached_item(self, i: int) -> np.ndarray:
        a = self._read(i)
        if np.issubdtype(self.dtype, np.integer):
            a = a.astype(np.int64)
            if self.fix_lua_indexing:
                a -= 1
        return a

    def __len__(self) -> int:
        return self._len

    def num_tokens(self, index: int) -> int:
        return int(self.sizes[self.dim_offsets[index]])

    def size(self, index: int) -> int:
        return int(self.sizes[self.dim_offsets[index]])

    @staticmethod
    def exists(path: str) -> bool:
        return os.path.exists(index_file_path(path)) and os.path.exists(data_file_path(path))


class FilterBanksDataset(IndexedDataset):
    """2-D float32 filterbanks (reference data/fbank_dataset.py:97-152):
    ``sizes`` holds (T, n_mels) pairs, and ``size(i)`` / ``num_tokens(i)``
    the frame count."""

    def __init__(self, path: str, legacy_audio_fix_lua_indexing: bool = False):
        super().__init__(path)
        if self.dtype != np.float32 or len(self.sizes) != len(self) * 2:
            raise ValueError(f"{path}: not a float32 2-D filterbank dataset")
        self.legacy_audio_fix_lua_indexing = legacy_audio_fix_lua_indexing

    @lru_cache(maxsize=8)
    def _cached_item(self, i: int) -> np.ndarray:
        a = self._read(i)
        return a - 1 if self.legacy_audio_fix_lua_indexing else a

    def num_tokens(self, index: int) -> int:
        return int(self.sizes[index * 2])

    def size(self, index: int) -> int:
        return int(self.sizes[index * 2])


class IndexedDatasetBuilder:
    """TNT writer of token datasets, with the +1 on write."""

    lua_compat_shift = 1

    def __init__(self, out_file: str, dtype=np.int32):
        self.out_file = open(out_file, "wb")
        self.dtype = np.dtype(dtype).type
        self.data_offsets = [0]
        self.dim_offsets = [0]
        self.sizes = []
        self.element_size = np.dtype(self.dtype).itemsize

    def add_item(self, array) -> None:
        array = np.asarray(array)
        if self.lua_compat_shift:
            array = array + self.lua_compat_shift
        nbytes = self.out_file.write(np.ascontiguousarray(array, dtype=self.dtype).tobytes())
        self.data_offsets.append(self.data_offsets[-1] + nbytes // self.element_size)
        self.sizes.extend(array.shape)
        self.dim_offsets.append(self.dim_offsets[-1] + array.ndim)

    def merge_file_(self, another_file: str) -> None:
        """Append the dataset at prefix ``another_file`` (of this dtype)."""
        index = IndexedDataset(another_file)
        assert index.dtype == self.dtype
        begin = self.data_offsets[-1]
        self.data_offsets.extend(begin + int(offset) for offset in index.data_offsets[1:])
        self.sizes.extend(int(s) for s in index.sizes)
        begin = self.dim_offsets[-1]
        self.dim_offsets.extend(begin + int(offset) for offset in index.dim_offsets[1:])
        with open(data_file_path(another_file), "rb") as f:
            shutil.copyfileobj(f, self.out_file)

    def finalize(self, index_file: str) -> None:
        self.out_file.close()
        with open(index_file, "wb") as index:
            index.write(_TNT_MAGIC)
            index.write(struct.pack("<Q", 1))
            index.write(struct.pack("<QQ", dtype_code(self.dtype), self.element_size))
            index.write(struct.pack("<QQ", len(self.data_offsets) - 1, len(self.sizes)))
            index.write(np.array(self.dim_offsets, dtype=np.int64).tobytes())
            index.write(np.array(self.data_offsets, dtype=np.int64).tobytes())
            index.write(np.array(self.sizes, dtype=np.int64).tobytes())


class AudioIndexedDatasetBuilder(IndexedDatasetBuilder):
    """float32 writer of multi-dimensional items (reference
    preprocess_audio.py:44-59): values stored as they are."""

    lua_compat_shift = 0

    def __init__(self, out_file: str):
        super().__init__(out_file, dtype=np.float32)


class MMapIndexedDataset:
    """Reader of the mmap format."""

    def __init__(self, path: str):
        self._path = path
        with open(index_file_path(path), "rb") as stream:
            if stream.read(9) != _MMAP_MAGIC:
                raise ValueError("Index file doesn't match expected format (MMIDIDX).")
            if struct.unpack("<Q", stream.read(8)) != (1,):
                raise ValueError("unknown MMIDIDX version")
            (code,) = struct.unpack("<B", stream.read(1))
            self._dtype = DTYPES[code]
            self._len = struct.unpack("<Q", stream.read(8))[0]
            offset = stream.tell()
        idx_buffer = memoryview(np.memmap(index_file_path(path), mode="r", order="C"))
        self._sizes = np.frombuffer(idx_buffer, dtype=np.int32, count=self._len, offset=offset)
        self._pointers = np.frombuffer(idx_buffer, dtype=np.int64, count=self._len,
                                       offset=offset + self._sizes.nbytes)
        self._bin_buffer = np.memmap(data_file_path(path), mode="r", order="C")

    def __len__(self) -> int:
        return self._len

    def __getitem__(self, i: int) -> np.ndarray:
        return self._cached_item(i).copy()

    @lru_cache(maxsize=8)
    def _cached_item(self, i: int) -> np.ndarray:
        a = np.frombuffer(self._bin_buffer, dtype=self._dtype, count=int(self._sizes[i]),
                          offset=int(self._pointers[i]))
        if self._dtype != np.int64 and np.issubdtype(self._dtype, np.integer):
            a = a.astype(np.int64)
        return a

    @property
    def dtype(self):
        return self._dtype

    @property
    def sizes(self) -> np.ndarray:
        return self._sizes

    def num_tokens(self, index: int) -> int:
        return int(self._sizes[index])

    def size(self, index: int) -> int:
        return int(self._sizes[index])

    @staticmethod
    def exists(path: str) -> bool:
        return os.path.exists(index_file_path(path)) and os.path.exists(data_file_path(path))


class MMapIndexedDatasetBuilder:
    def __init__(self, out_file: str, dtype=np.int64):
        self._data_file = open(out_file, "wb")
        self._dtype = np.dtype(dtype).type
        self._sizes = []

    def add_item(self, array) -> None:
        a = np.ascontiguousarray(np.asarray(array), dtype=self._dtype)
        self._data_file.write(a.tobytes(order="C"))
        self._sizes.append(a.size)

    def merge_file_(self, another_file: str) -> None:
        """Append the dataset at prefix ``another_file`` (of this dtype)."""
        index = MMapIndexedDataset(another_file)
        assert index.dtype == self._dtype
        self._sizes.extend(int(s) for s in index.sizes)
        with open(data_file_path(another_file), "rb") as f:
            shutil.copyfileobj(f, self._data_file)

    def finalize(self, index_file: str) -> None:
        self._data_file.close()
        with open(index_file, "wb") as f:
            f.write(_MMAP_MAGIC)
            f.write(struct.pack("<Q", 1))
            f.write(struct.pack("<B", dtype_code(self._dtype)))
            f.write(struct.pack("<Q", len(self._sizes)))
            sizes = np.array(self._sizes, dtype=np.int32)
            pointers = np.zeros(len(self._sizes), dtype=np.int64)
            if len(self._sizes) > 1:
                np.cumsum(sizes[:-1] * np.dtype(self._dtype).itemsize, out=pointers[1:])
            f.write(sizes.tobytes(order="C"))
            f.write(pointers.tobytes(order="C"))


class IndexedRawTextDataset:
    """A text file binarized in memory (reference indexed_dataset.py:230-283)."""

    def __init__(self, path: str, dictionary, append_eos: bool = True, reverse_order: bool = False):
        self.tokens_list, self.lines, sizes = [], [], []
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                self.lines.append(line.strip("\n"))
                tokens = dictionary.encode_line(line, add_if_not_exist=False, append_eos=append_eos,
                                                reverse_order=reverse_order)
                self.tokens_list.append(tokens)
                sizes.append(len(tokens))
        self.sizes = np.array(sizes)

    def __getitem__(self, i: int) -> np.ndarray:
        if i < 0 or i >= len(self.tokens_list):
            raise IndexError("index out of range")
        return self.tokens_list[i]

    def __len__(self) -> int:
        return len(self.tokens_list)

    def num_tokens(self, index: int) -> int:
        return int(self.sizes[index])

    def size(self, index: int) -> int:
        return int(self.sizes[index])

    @staticmethod
    def exists(path: str) -> bool:
        return os.path.exists(path)
