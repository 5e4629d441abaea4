"""Random object identifiers.

Reference: identity/randomid.go — 128-bit random values rendered in Crockford
base32, fixed length, lowercase.

The port's own copy of the JAX package's utils/identity.py.
"""

import os

# Crockford base32 alphabet (lowercased), no i/l/o/u.
_ALPHABET = "0123456789abcdefghjkmnpqrstvwxyz"
_ID_BITS = 128
_ID_LEN = 25  # ceil(128/5)


def new_id() -> str:
    """Return a 25-char Crockford-base32 encoding of 128 random bits."""
    n = int.from_bytes(os.urandom(_ID_BITS // 8), "big")
    chars = []
    for _ in range(_ID_LEN):
        chars.append(_ALPHABET[n & 31])
        n >>= 5
    return "".join(reversed(chars))
