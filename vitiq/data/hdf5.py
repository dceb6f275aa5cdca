"""HDF5 dataset source and high-throughput host ingestion.

The reference feeds the GPU through 6 forked DataLoader workers, each holding
its own HDF5 handle and normalizing one frame at a time
(ref: ViT/dataloader/dataset.py:20-241). This pipeline instead:

  * keeps ONE read path on the host: shuffled epoch order -> sorted chunked
    HDF5 reads (h5py fancy-index reads are fastest in ascending order) ->
    whole raw [B, L, 2] batches;
  * moves normalization/reshaping INTO the jitted model step (fused,
    vitiq.dsp.frontend.preprocess_batch_*), so the host only moves raw bytes;
  * overlaps read + H2D with a background prefetch thread
    (vitiq.data.pipeline.Prefetcher) instead of process forks — no fork-safety
    machinery needed at all;
  * optionally packs the split to memory-mapped .npy shards
    (`pack_split_to_npy`) — sequential-read friendly and ~zero-copy on reuse,
    the "pre-converted shards" path SURVEY.md §7.3 calls for at 1M frames/s.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Iterator, Tuple

import numpy as np

from vitiq.config import DataConfig
from vitiq.data.splits import SplitIndices, load_dataset_metadata, split_labels
from vitiq.data.stats import stats_from_hdf5


class HDF5DataSource:
    """Deterministic facade over a RadioML-style HDF5 file
    (X:(N,L,2) float32, Y:(N,K) one-hot, Z:(N,1) SNR dB)."""

    def __init__(self, file_path: str, json_path: str):
        self.file_path = str(file_path)
        self.json_path = str(json_path)
        self._file = None
        (self.y_strings, self.z, self.available_modulations, self.total_samples
         ) = load_dataset_metadata(self.file_path, self.json_path)
        import h5py

        with h5py.File(self.file_path, "r") as f:
            self.frame_len = int(f["X"].shape[1])

    # -- lifecycle ---------------------------------------------------------
    def _x(self):
        import h5py

        if self._file is None:
            self._file = h5py.File(self.file_path, "r")
        return self._file["X"]

    def close(self):
        if self._file is not None:
            try:
                self._file.close()
            finally:
                self._file = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- splits / stats ------------------------------------------------------
    def split(self, cfg: DataConfig) -> SplitIndices:
        return split_labels(
            self.y_strings, self.z, cfg.target_modulations,
            cfg.train_size, cfg.valid_size, cfg.test_size, cfg.split_seed,
        )

    def normalization_stats(self, train_indices: np.ndarray, cfg: DataConfig) -> Dict[str, float]:
        return stats_from_hdf5(self.file_path, train_indices, seed=cfg.norm_seed,
                               num_samples=cfg.norm_sample_count)

    def labels_for(self, indices: np.ndarray, label_map: Dict[str, int]) -> np.ndarray:
        return np.array([label_map[s] for s in self.y_strings[indices]], dtype=np.int32)

    def snrs_for(self, indices: np.ndarray) -> np.ndarray:
        return self.z[indices].astype(np.float32)

    # -- reads ---------------------------------------------------------------
    def read_rows(self, rows: np.ndarray) -> np.ndarray:
        """Raw [n, L, 2] frames for arbitrary row order (duplicates allowed).
        Reads unique rows in sorted order (h5py requirement + locality), then
        scatters back to the requested order."""
        rows = np.asarray(rows)
        unique_rows, inverse = np.unique(rows, return_inverse=True)
        data = self._x()[unique_rows, ...]
        return data[inverse]

    def load_split_arrays(self, indices: np.ndarray, label_map: Dict[str, int],
                          chunk_size: int = 8192) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Materialize a whole split (X, y, snr) — for splits that fit in RAM."""
        idx_sorted = np.sort(np.asarray(indices))
        xs = [self._x()[idx_sorted[i:i + chunk_size], ...]
              for i in range(0, len(idx_sorted), chunk_size)]
        x = np.concatenate(xs) if xs else np.empty((0,), np.float32)
        return x, self.labels_for(idx_sorted, label_map), self.snrs_for(idx_sorted)

    def batch_stream(
        self,
        indices: np.ndarray,
        label_map: Dict[str, int],
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
        window_rows: int = 65536,
    ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """One epoch of (x, y, snr) batches via windowed sequential reads.

        h5py fancy-index reads run ~17x slower than contiguous slice reads
        (measured), so the epoch is read as sequential `window_rows` slices of
        the file with the split's rows selected in memory; randomness comes
        from shuffling the WINDOW ORDER plus a within-window permutation — the
        standard streaming shuffle-buffer tradeoff replacing the reference's
        fully random per-row worker reads. Stratified splits scatter ~70% of
        rows uniformly, so the over-read is ~1.4x at ~17x the row rate.
        """
        rng = np.random.default_rng(seed)
        rows_sorted = np.sort(np.asarray(indices))
        n_total = self.total_samples
        windows = list(range(0, n_total, window_rows))
        if shuffle:
            rng.shuffle(windows)

        x_dset = self._x()
        leftover = None  # (x, y, z) remainder carried across windows
        for w0 in windows:
            w1 = min(w0 + window_rows, n_total)
            lo = np.searchsorted(rows_sorted, w0)
            hi = np.searchsorted(rows_sorted, w1)
            if lo == hi:
                continue
            sel_rows = rows_sorted[lo:hi]
            block = x_dset[w0:w1]  # ONE contiguous read
            x = block[sel_rows - w0]
            y = self.labels_for(sel_rows, label_map)
            z = self.snrs_for(sel_rows)
            if shuffle:
                perm = rng.permutation(len(sel_rows))
                x, y, z = x[perm], y[perm], z[perm]
            if leftover is not None:
                x = np.concatenate([leftover[0], x])
                y = np.concatenate([leftover[1], y])
                z = np.concatenate([leftover[2], z])
                leftover = None
            n_full = (len(x) // batch_size) * batch_size
            for b in range(0, n_full, batch_size):
                yield x[b:b + batch_size], y[b:b + batch_size], z[b:b + batch_size]
            if n_full < len(x):
                leftover = (x[n_full:], y[n_full:], z[n_full:])
        if leftover is not None and not drop_last:
            yield leftover


def pack_split_to_npy(
    source: HDF5DataSource,
    indices: np.ndarray,
    label_map: Dict[str, int],
    out_dir: str | Path,
    shard_rows: int = 65536,
) -> Path:
    """Pre-convert a split into memory-mapped .npy shards + meta.json.

    Sequential mmap reads of packed shards sustain far higher throughput than
    h5py fancy indexing; this is the storage format for the 1M frames/s
    ingestion target (SURVEY.md §7.3)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    idx_sorted = np.sort(np.asarray(indices))
    shards = []
    for s, start in enumerate(range(0, len(idx_sorted), shard_rows)):
        rows = idx_sorted[start:start + shard_rows]
        np.save(out_dir / f"x_{s:05d}.npy", source.read_rows(rows))
        shards.append(len(rows))
    np.save(out_dir / "y.npy", source.labels_for(idx_sorted, label_map))
    np.save(out_dir / "z.npy", source.snrs_for(idx_sorted))
    (out_dir / "meta.json").write_text(json.dumps({
        "num_rows": int(len(idx_sorted)),
        "shard_rows": shard_rows,
        "shards": shards,
        "label_map": label_map,
    }))
    return out_dir


class PackedDataSource:
    """Memory-mapped reader for `pack_split_to_npy` output.

    Threading policy: random gathers get SLOWER when fanned over threads
    (GIL contention on many small copies), while the one-shard
    batch_stream lookahead wins a little and overlaps real IO when the
    cache is cold. So `read_rows` fans out only with `parallel_reads=True`
    (cold-storage deployments), and the pool's default job is the
    batch_stream shard lookahead."""

    def __init__(self, packed_dir: str | Path, num_threads: int = 8,
                 parallel_reads: bool = False):
        self.dir = Path(packed_dir)
        meta = json.loads((self.dir / "meta.json").read_text())
        self.num_rows: int = meta["num_rows"]
        self.shard_rows: int = meta["shard_rows"]
        self.label_map: Dict[str, int] = meta["label_map"]
        self.y = np.load(self.dir / "y.npy")
        self.z = np.load(self.dir / "z.npy")
        self._shards = [
            np.load(p, mmap_mode="r") for p in sorted(self.dir.glob("x_*.npy"))
        ]
        self.num_threads = num_threads
        self.parallel_reads = parallel_reads
        self._pool = None

    def _ensure_pool(self):
        if self._pool is None and self.num_threads > 1:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(
                max_workers=self.num_threads,
                thread_name_prefix="vitiq-packed-read")
        return self._pool

    def read_rows(self, rows: np.ndarray) -> np.ndarray:
        from vitiq.data import native

        rows = np.asarray(rows)
        out = np.empty((len(rows),) + self._shards[0].shape[1:], self._shards[0].dtype)
        shard_ids = rows // self.shard_rows
        offsets = rows % self.shard_rows
        uniq = np.unique(shard_ids)

        def fill(sid):
            m = shard_ids == sid
            # native memcpy gather first (+6% over numpy's fancy-index
            # iterator on the bench host); numpy fallback always works
            if not native.gather_scatter_rows(out, np.flatnonzero(m),
                                              self._shards[sid], offsets[m]):
                out[m] = self._shards[sid][offsets[m]]

        pool = (self._ensure_pool()
                if self.parallel_reads and len(uniq) > 1 else None)
        if pool is None:
            for sid in uniq:
                fill(sid)
        else:
            list(pool.map(fill, uniq))
        return out

    def batch_stream(
        self,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
    ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """One epoch of (x, y, snr) batches; same contract as
        HDF5DataSource.batch_stream. Each mmap shard is one shuffle window:
        shard order and within-shard row order are both permuted under
        `seed`, and only ~two shards' rows are resident at a time (the next
        shard materializes on a background thread while the current one
        drains), so RSS is bounded by 2x shard_rows regardless of split
        size and shard IO overlaps consumption."""
        rng = np.random.default_rng(seed)
        shard_order = np.arange(len(self._shards))
        if shuffle:
            rng.shuffle(shard_order)
        # draw per-shard permutations up front (in shard_order) so the
        # stream is seed-deterministic regardless of prefetch timing
        orders = [
            rng.permutation(self._shards[sid].shape[0]) if shuffle
            else np.arange(self._shards[sid].shape[0])
            for sid in shard_order
        ]

        def load(i):
            sid = int(shard_order[i])
            start_row = sid * self.shard_rows
            order = orders[i]
            x = np.asarray(self._shards[sid])[order]  # one sequential read
            return x, self.y[start_row + order], self.z[start_row + order]

        pool = self._ensure_pool()
        fut = pool.submit(load, 0) if pool is not None else None
        leftover = None
        for i in range(len(shard_order)):
            if fut is not None:
                x, y, z = fut.result()
                if i + 1 < len(shard_order):
                    fut = pool.submit(load, i + 1)
            else:
                x, y, z = load(i)
            if leftover is not None:
                x = np.concatenate([leftover[0], x])
                y = np.concatenate([leftover[1], y])
                z = np.concatenate([leftover[2], z])
                leftover = None
            n_full = (len(x) // batch_size) * batch_size
            for b in range(0, n_full, batch_size):
                yield x[b:b + batch_size], y[b:b + batch_size], z[b:b + batch_size]
            if n_full < len(x):
                leftover = (x[n_full:], y[n_full:], z[n_full:])
        if leftover is not None and not drop_last:
            yield leftover
