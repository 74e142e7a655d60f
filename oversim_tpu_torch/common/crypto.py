"""CryptoModule — RPC message authentication (host side, PyTorch port).

Counterpart of ``oversim_tpu/common/crypto.py``, itself a rebuild of the
reference CryptoModule (src/common/CryptoModule.{h,cc}: signs/verifies
an AuthBlock on RPC messages — ``signMessage`` CryptoModule.h:56,
AuthBlock fields CommonMessages.msg:172-177,217).  In simulation only
the overhead is modelled (``auth_overhead``); the gateway
(``oversim_tpu_torch/gateway.py``) attaches the real check: an HMAC-SHA1
auth block over the exact wire bytes of every frame (``CryptoModule``).
Nothing here touches a tensor.
"""

from __future__ import annotations

import dataclasses
import hashlib
import hmac

AUTHBLOCK_B = 140   # certificate + signature bytes (AUTHBLOCK_L / 8)


@dataclasses.dataclass(frozen=True)
class CryptoParams:
    enabled: bool = False         # sign all RPCs (overhead model)
    sign_cost_s: float = 0.0005   # modeled signing latency
    verify_cost_s: float = 0.0008


def auth_overhead(p: CryptoParams) -> int:
    """Extra wire bytes per signed RPC (added to size_b by callers)."""
    return AUTHBLOCK_B if p.enabled else 0


def sign(key: bytes, payload: bytes) -> bytes:
    """Host-side real signature for the gateway path (HMAC stand-in for
    the reference's RSA keyFile signatures)."""
    return hmac.new(key, payload, hashlib.sha1).digest()


def verify(key: bytes, payload: bytes, signature: bytes) -> bool:
    return hmac.compare_digest(sign(key, payload), signature)


SIG_B = 20          # sha1 digest width
AUTH_MAGIC = b"AUTH"


class CryptoModule:
    """Real-signature path for SingleHost/gateway frames.

    The reference CryptoModule signs every RPC message in SingleHost
    mode with the node key loaded from ``keyFile`` (CryptoModule.h:56
    signMessage; the module serializes the message, hashes it, and
    appends an AuthBlock {pubKey, signature, cert},
    CryptoModule.cc:57-83; verifyMessage rejects messages without an
    AuthBlock, :86-90).  This rebuild attaches a REAL check: an
    HMAC-SHA1 auth block over the exact wire bytes, keyed from the
    key file — message tampering or a missing/foreign block fails
    verification, the property the reference's (stubbed) RSA path is
    structured for.

    Stats mirror the reference's RECORD_STATS counters (numSign).
    """

    def __init__(self, key_file: str | None = None,
                 key: bytes | None = None):
        if key is not None:
            self.key = key
        elif key_file is not None:
            # keyFile discipline: created on first use so every node of
            # a deployment can share one provisioned secret.  O_EXCL
            # makes provisioning race-free (two concurrent first users
            # cannot silently overwrite each other's key) and 0o600
            # keeps the secret out of world-readable mode.
            import os
            try:
                fd = os.open(key_file,
                             os.O_WRONLY | os.O_CREAT | os.O_EXCL, 0o600)
            except FileExistsError:
                with open(key_file, "rb") as f:
                    self.key = f.read()
            else:
                self.key = os.urandom(32)
                with os.fdopen(fd, "wb") as f:
                    f.write(self.key)
        else:
            raise ValueError("CryptoModule needs key_file or key")
        self.num_sign = 0
        self.num_verify = 0
        self.num_verify_failed = 0

    def sign_frame(self, frame: bytes) -> bytes:
        """signMessage: append the auth block to the wire frame."""
        self.num_sign += 1
        return frame + AUTH_MAGIC + sign(self.key, frame)

    def verify_frame(self, data: bytes) -> bytes | None:
        """verifyMessage: check + strip the auth block; None = reject
        (no block, truncated block, or bad signature)."""
        self.num_verify += 1
        tail = SIG_B + len(AUTH_MAGIC)
        if (len(data) < tail
                or data[-tail:-SIG_B] != AUTH_MAGIC
                or not verify(self.key, data[:-tail], data[-SIG_B:])):
            self.num_verify_failed += 1
            return None
        return data[:-tail]
