"""Disk cache for judge calls (ragas_modified/cache.py surface, without
the diskcache dependency): hash(func qualname + args) -> JSON file."""

from __future__ import annotations

import functools
import hashlib
import json
import os
from typing import Any, Optional


class CacheInterface:
    def get(self, key: str) -> Optional[Any]:
        raise NotImplementedError

    def set(self, key: str, value: Any) -> None:
        raise NotImplementedError

    def has_key(self, key: str) -> bool:
        raise NotImplementedError


class DiskCacheBackend(CacheInterface):
    def __init__(self, cache_dir: str = ".cache/anr_eval"):
        self.cache_dir = cache_dir
        os.makedirs(cache_dir, exist_ok=True)

    def _path(self, key: str) -> str:
        return os.path.join(self.cache_dir, f"{key}.json")

    def get(self, key):
        try:
            with open(self._path(key)) as f:
                return json.load(f)["value"]
        except (OSError, ValueError, KeyError):
            return None

    def set(self, key, value):
        with open(self._path(key), "w") as f:
            json.dump({"value": value}, f)

    def has_key(self, key):
        return os.path.exists(self._path(key))


class InMemoryCacheBackend(CacheInterface):
    def __init__(self):
        self.store = {}

    def get(self, key):
        return self.store.get(key)

    def set(self, key, value):
        self.store[key] = value

    def has_key(self, key):
        return key in self.store


def _cache_key(fn, args, kwargs) -> str:
    payload = json.dumps(
        {"fn": fn.__qualname__, "args": [repr(a) for a in args],
         "kwargs": {k: repr(v) for k, v in sorted(kwargs.items())}},
        sort_keys=True,
    )
    return hashlib.sha256(payload.encode()).hexdigest()[:32]


def cacher(backend: Optional[CacheInterface] = None):
    """Decorator caching (a)sync function results by hashed arguments."""

    def deco(fn):
        cache = backend or InMemoryCacheBackend()
        import asyncio

        if asyncio.iscoroutinefunction(fn):
            @functools.wraps(fn)
            async def awrapper(*args, **kwargs):
                key = _cache_key(fn, args, kwargs)
                if cache.has_key(key):
                    return cache.get(key)
                out = await fn(*args, **kwargs)
                cache.set(key, out)
                return out

            return awrapper

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            key = _cache_key(fn, args, kwargs)
            if cache.has_key(key):
                return cache.get(key)
            out = fn(*args, **kwargs)
            cache.set(key, out)
            return out

        return wrapper

    return deco
