"""Storage URL helper (counterpart of ray_tpu/util/fs.py) — neutral ground
for the layers that take storage URLs (the object-store spill tier), so
core never imports from a library package.

The JAX package reaches remote filesystems (``s3://``, ``gs://``,
``memory://``) through fsspec. The machine the port runs on does not
have fsspec, so the port takes plain local paths only and refuses a URL
with a scheme by name."""
from __future__ import annotations


def split_fs_url(uri: str):
    """-> (None for plain-local, root path). Raises ValueError on a URL
    with a scheme: remote spill tiers are not ported."""
    if "://" not in uri:
        return None, uri
    raise ValueError(
        f"{uri!r}: storage URLs need fsspec, which the port does not "
        f"carry; give a local directory")
