"""External secret-driver provider seam.

Reference: manager/drivers/provider.go + secrets.go — a DriverProvider
resolves the Driver named in a SecretSpec to a plugin and fetches the
secret VALUE from it at assignment time (the store only holds the driver
name; the payload never rests in raft). The reference discovers plugins via
docker's plugingetter over HTTP; here drivers are objects registered with
the provider (in-process plugins), keeping the same seam shape:
``provider.new_secret_driver(spec.driver).get(spec, task)``.

The port's own copy of the JAX package's manager/drivers.py.
"""

from __future__ import annotations

from typing import Protocol

MAX_SECRET_SIZE = 500 * 1024  # reference: validation.MaxSecretSize


class DriverError(Exception):
    pass


class SecretDriver(Protocol):
    """reference: drivers.SecretDriver — Get(spec, task) -> payload."""

    def get(self, spec, task) -> bytes: ...


class DriverProvider:
    """reference: drivers.DriverProvider provider.go."""

    def __init__(self) -> None:
        self._secret_drivers: dict[str, SecretDriver] = {}

    def register_secret_driver(self, name: str, driver: SecretDriver) -> None:
        self._secret_drivers[name] = driver

    def new_secret_driver(self, driver_spec) -> SecretDriver:
        """reference: NewSecretDriver provider.go:21."""
        if driver_spec is None or not driver_spec.name:
            raise DriverError("driver specification is nil")
        d = self._secret_drivers.get(driver_spec.name)
        if d is None:
            raise DriverError(f"secret driver {driver_spec.name!r} "
                              "not registered")
        return d


def resolve_secret(provider, read_tx, task, secret_id):
    """Populate a secret's value — from the store for ordinary secrets,
    from its driver for external ones (reference: assignmentSet.secret
    dispatcher/assignments.go:294-316). Returns a COPY with data filled,
    or raises DriverError."""
    secret = read_tx.get("secret", secret_id)
    if secret is None:
        raise DriverError(f"secret {secret_id} not found")
    if secret.spec.driver is None or not secret.spec.driver.name:
        return secret
    if provider is None:
        raise DriverError(
            f"secret {secret_id} needs driver "
            f"{secret.spec.driver.name!r} but no provider is configured")
    driver = provider.new_secret_driver(secret.spec.driver)
    value = driver.get(secret.spec, task)
    if not isinstance(value, (bytes, bytearray)) \
            or len(value) > MAX_SECRET_SIZE:
        raise DriverError(
            f"driver {secret.spec.driver.name!r} returned an invalid "
            "payload (reference: ValidateSecretPayload)")
    out = secret.copy()
    out.spec.data = bytes(value)
    return out
