from swarmkit_tpu_torch.encryption.encryption import (
    Decrypter, Encrypter, FernetCrypter, MaybeEncryptedRecord, MultiDecrypter,
    NopCrypter, SecretboxCrypter, defaults, generate_secret_key,
    human_readable_key, parse_human_readable_key,
)

__all__ = [
    "Decrypter", "Encrypter", "FernetCrypter", "MaybeEncryptedRecord",
    "MultiDecrypter", "NopCrypter", "SecretboxCrypter", "defaults",
    "generate_secret_key", "human_readable_key", "parse_human_readable_key",
]
