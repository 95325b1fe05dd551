"""IAM: identity, named policies, and the policy evaluation engine
(cmd/iam.go + pkg/iam/policy)."""

from .policy import (  # noqa: F401
    ALL_ACTIONS,
    BUCKET_ACTIONS,
    CANNED_POLICIES,
    OBJECT_ACTIONS,
    Args,
    Policy,
    PolicyError,
    Statement,
)
from .sys import (  # noqa: F401
    IAMError,
    IAMSys,
    PolicyNotFound,
    UserNotFound,
    generate_credentials,
)
