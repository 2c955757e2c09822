"""Video frame sampling (reference preprocess/preprocess_videos.py:8-107).

Two modes:
  * dump_frames: artifact-parity mode -- decode with OpenCV, sample one
    frame every fps//2 frames (~2 fps), write jpgs named
    video{id}_{count}_cls{brandidx}.jpg (exact reference naming).
  * iter_sampled_frames: fused-pipeline mode -- yields (frame_name,
    224x224x3 uint8 array) without touching disk, feeding the ResNet
    extractor directly (the reference's imwrite-then-reread round
    trip was its preprocessing bottleneck).
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from fancyrec_tpu_torch.io.dictfile import write_dict


def _list_videos(root: str, categories) -> List[Tuple[int, str, str]]:
    """-> [(brand_index, category, filename)] in the reference's sorted
    iteration order (categories sorted, files sorted, mp4 only)."""
    if isinstance(categories, str):
        categories = os.listdir(categories)
    categories = sorted(categories)
    out = []
    for index, cate in enumerate(categories):
        for f in sorted(os.listdir(os.path.join(root, cate))):
            if f.endswith("mp4"):
                out.append((index, cate, f))
    return out


def iter_video_frames(path: str, resize: Optional[Tuple[int, int]] = None
                      ) -> Iterator[Tuple[int, np.ndarray]]:
    """Decode a video, yielding (frame_count, RGB array) for every sampled
    frame (one per fps//2 frames, matching preprocess_videos.py:36-38)."""
    import cv2

    cap = cv2.VideoCapture(path)
    fps = int(round(cap.get(cv2.CAP_PROP_FPS))) or 30
    interval = max(fps // 2, 1)
    count = 0
    ok = cap.isOpened()
    if ok:
        ok = cap.grab()
    while ok:
        # grab() decodes without the BGR conversion + frame copy;
        # retrieve() materializes only the ~1-in-(fps//2) sampled frames.
        # Same frames as read() everywhere (pinned byte-identical vs the
        # reference artifacts in test_reference_preprocess_oracle); speeds
        # single-core decode (measured by the JAX package's bench.py
        # preprocess on its host).
        ok = cap.grab()
        if not ok:
            break
        if count % interval == 0:
            ok, frame = cap.retrieve()
            if not ok:
                break
            if resize is not None:
                frame = cv2.resize(frame, resize)
            yield count, frame[:, :, ::-1]  # BGR -> RGB
        count += 1
    cap.release()


def dump_frames(root: str, categories, frames_save_path: str) -> int:
    """Artifact-parity frame dump (cv2.imwrite per sampled frame)."""
    import cv2

    os.makedirs(frames_save_path, exist_ok=True)
    video_id = 0
    written = 0
    for brand_idx, cate, fname in _list_videos(root, categories):
        video_id += 1
        for count, rgb in iter_video_frames(os.path.join(root, cate, fname)):
            frame_name = "video%d_%d_cls%d.jpg" % (video_id, count, brand_idx)
            cv2.imwrite(os.path.join(frames_save_path, frame_name),
                        rgb[:, :, ::-1])
            written += 1
    return written


def iter_sampled_frames(root: str, categories, resize=(224, 224)
                        ) -> Iterator[Tuple[str, np.ndarray]]:
    """Fused mode: (frame_name_without_ext, HxWx3 uint8 RGB) stream."""
    video_id = 0
    for brand_idx, cate, fname in _list_videos(root, categories):
        video_id += 1
        for count, rgb in iter_video_frames(os.path.join(root, cate, fname),
                                            resize=resize):
            yield "video%d_%d_cls%d" % (video_id, count, brand_idx), rgb


def _decode_video_task(args):
    """Top-level (spawn-picklable) per-video decode: -> [(frame_name, rgb)].

    Runs in decode worker processes/threads; imports only cv2 + numpy (the
    package __init__s are docstring-only and io imports numpy alone, so
    spawn startup stays cheap and the workers never touch torch or the
    parent's CUDA context)."""
    path, video_id, brand_idx, resize = args
    return [("video%d_%d_cls%d" % (video_id, count, brand_idx), rgb)
            for count, rgb in iter_video_frames(path, resize=resize)]


def iter_sampled_frames_parallel(root: str, categories, resize=(224, 224),
                                 workers: int = 4, backend: str = "process"
                                 ) -> Iterator[Tuple[str, np.ndarray]]:
    """Decode-ahead variant of iter_sampled_frames: up to `workers` videos
    decode concurrently, while frames are yielded strictly in the
    reference's sorted video order so the BigFile id.txt ordering stays
    byte-identical to the serial mode.

    backend="process" (default) uses spawn-based worker PROCESSES -- on a
    multi-core preprocess host each worker owns a core, so decode scales
    past the GIL and past cv2's decoder lock contention (the JAX package's
    bench.py preprocess found threads counterproductive on a 1-core host:
    overlap_speedup 0.84 serial vs 0.71 threaded). Frames cross back by pickle (~150 KB
    per 224x224 frame -- cheap next to decode). backend="thread" keeps the
    in-process pool (no pickling; decode releases the GIL). workers<=1, or
    a host where process pools cannot start (hosts without /dev/shm),
    degrades gracefully to the serial path.

    Spawn caveat: worker processes re-import ``__main__``; a caller
    driving this from a script must guard its top level with
    ``if __name__ == "__main__":`` (the shipped CLIs already do)."""
    videos = _list_videos(root, categories)
    workers = max(workers, 1)

    def serial():
        for item in iter_sampled_frames(root, categories, resize=resize):
            yield item

    if workers == 1 or not videos:
        yield from serial()
        return

    if backend == "process":
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor
        try:
            pool = ProcessPoolExecutor(
                max_workers=workers,
                mp_context=multiprocessing.get_context("spawn"))
        except (OSError, ValueError, ImportError) as e:  # no /dev/shm etc.
            print("decode process pool unavailable (%s); serial decode" % e,
                  flush=True)
            yield from serial()
            return
    elif backend == "thread":
        from concurrent.futures import ThreadPoolExecutor
        pool = ThreadPoolExecutor(max_workers=workers)
    else:
        raise ValueError("backend must be 'process' or 'thread': %r" % backend)

    from collections import deque

    from concurrent.futures.process import BrokenProcessPool

    try:
        with pool:
            # bounded in-flight window (Executor.map would submit every
            # video up front and hold all decoded frames in memory)
            pending = deque()
            it = iter(
                (os.path.join(root, cate, fname), vid, brand_idx, resize)
                for vid, (brand_idx, cate, fname)
                in enumerate(videos, start=1))
            for args in it:
                pending.append(pool.submit(_decode_video_task, args))
                if len(pending) >= workers + 1:
                    break
            while pending:
                for item in pending.popleft().result():
                    yield item
                nxt = next(it, None)
                if nxt is not None:
                    pending.append(pool.submit(_decode_video_task, nxt))
    except BrokenProcessPool as e:
        raise RuntimeError(
            "decode worker process died (%s); re-run with workers=1 or "
            "backend='thread'" % e) from e


def video2idx_and_idx2video(root_path: str, categories, out_path: str) -> dict:
    """video name <-> running id maps (preprocess_videos.py:73-107)."""
    video2idx: Dict[str, int] = {}
    idx2video: Dict[int, str] = {}
    video_id = 0
    dups = 0
    for _, cate, fname in _list_videos(root_path, categories):
        video_id += 1
        name = fname[:-4]
        if name not in video2idx:
            video2idx[name] = video_id
            idx2video[video_id] = name
        else:
            dups += 1
    info = {"video2idx": video2idx, "idx2video": idx2video}
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        write_dict(out_path, info)
    return info
