"""Error codes and exceptions.

Mirrors the reference's return-code semantics (reference:
``src/include/starneig/error.h:66-127``): the library distinguishes
*algorithmic* failures (non-convergence, partial reordering, close
eigenvalues) from usage errors.  Algorithmic failures leave the outputs in a
documented, still-valid state (e.g. a valid Schur form with an updated
selection vector) — callers can inspect ``info`` values rather than catch
exceptions on those paths.
"""

from __future__ import annotations

import enum


class Error(enum.IntEnum):
    """Return/info codes (reference: error.h:66-127)."""

    SUCCESS = 0
    GENERIC_ERROR = 1
    INVALID_CONFIGURATION = 2
    INVALID_ARGUMENTS = 3
    INVALID_DISTR_MATRIX = 4
    DID_NOT_CONVERGE = 5
    PARTIAL_REORDERING = 6
    CLOSE_EIGENVALUES = 7
    NOT_INITIALIZED = 8


class StarneigError(Exception):
    """Base exception for usage errors (invalid args/config)."""

    code = Error.GENERIC_ERROR


class InvalidArgumentsError(StarneigError):
    code = Error.INVALID_ARGUMENTS


class InvalidConfigurationError(StarneigError):
    code = Error.INVALID_CONFIGURATION


class NotInitializedError(StarneigError):
    code = Error.NOT_INITIALIZED


class DidNotConvergeError(StarneigError):
    """Raised only when the caller asked for raise-on-failure semantics.

    The default API returns ``Error.DID_NOT_CONVERGE`` in ``info`` with the
    matrix left partially reduced (reference: error.h:105-111).
    """

    code = Error.DID_NOT_CONVERGE
