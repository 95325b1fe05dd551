"""Gateway mode: serve the S3 API over non-erasure backends
(cmd/gateway/).

Two gateways, matching the reference's production pair:

- **nas** - a shared filesystem served with the full S3 front
  (cmd/gateway/nas/): rides :class:`minio_tpu_torch.objectlayer.fs.FSObjects`.
- **s3** - proxy to an upstream S3-compatible store
  (cmd/gateway/s3/): :class:`minio_tpu_torch.gateway.s3.S3Objects`
  implements the ObjectLayer over SigV4 HTTP calls.

The azure/gcs/hdfs gateways of the reference need SDKs this image
does not carry; their seam is the same ObjectLayer contract S3Objects
implements.

This package's copy of ``minio_tpu.gateway``: the upstream client's
signing code is its own, and its canonical requests and signatures are
the JAX client's byte for byte under the same clock.  A Select on a
gateway spools the object from the upstream and scans it on the
server's device (server/select.py).
"""

from .s3 import S3Objects  # noqa: F401
