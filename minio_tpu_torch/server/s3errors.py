"""S3 API error model (cmd/api-errors.go, 2102 lines in the reference).

Each error code carries its HTTP status and default message; exceptions
from lower layers map onto codes via ``from_exception`` (the toAPIError
translation, api-errors.go:1763).  Only the exception classes this
package has are mapped; ``NotImplementedError`` - a feature not ported
yet - becomes ``NotImplemented`` with the message that names its slice.
"""

from __future__ import annotations

import dataclasses
from http import HTTPStatus as H

from ..objectlayer import api as olapi
from ..storage import errors as serrors
from ..utils.hashreader import BadDigest, SizeMismatch
from .auth import AuthError
from .s3errors_table import VARIANTS


@dataclasses.dataclass(frozen=True)
class APIError:
    code: str
    message: str
    status: int


_E = {
    "AccessDenied": ("Access Denied.", H.FORBIDDEN),
    "BadDigest": ("The Content-Md5 you specified did not match what we received.", H.BAD_REQUEST),
    "BucketAlreadyExists": ("The requested bucket name is not available.", H.CONFLICT),
    "BucketAlreadyOwnedByYou": ("Your previous request to create the named bucket succeeded and you already own it.", H.CONFLICT),
    "BucketNotEmpty": ("The bucket you tried to delete is not empty.", H.CONFLICT),
    "EntityTooLarge": ("Your proposed upload exceeds the maximum allowed object size.", H.BAD_REQUEST),
    "EntityTooSmall": ("Your proposed upload is smaller than the minimum allowed object size.", H.BAD_REQUEST),
    "ExpiredToken": ("The provided token has expired.", H.BAD_REQUEST),
    "IncompleteBody": ("You did not provide the number of bytes specified by the Content-Length HTTP header.", H.BAD_REQUEST),
    "InternalError": ("We encountered an internal error, please try again.", H.INTERNAL_SERVER_ERROR),
    "InvalidAccessKeyId": ("The Access Key Id you provided does not exist in our records.", H.FORBIDDEN),
    "InvalidArgument": ("Invalid Argument", H.BAD_REQUEST),
    "InvalidBucketName": ("The specified bucket is not valid.", H.BAD_REQUEST),
    "InvalidDigest": ("The Content-Md5 you specified is not valid.", H.BAD_REQUEST),
    "InvalidPart": ("One or more of the specified parts could not be found.", H.BAD_REQUEST),
    "InvalidPartOrder": ("The list of parts was not in ascending order.", H.BAD_REQUEST),
    "InvalidRange": ("The requested range is not satisfiable", H.REQUESTED_RANGE_NOT_SATISFIABLE),
    "InvalidRequest": ("Invalid Request", H.BAD_REQUEST),
    "KeyTooLongError": ("Your key is too long", H.BAD_REQUEST),
    "MalformedDate": ("Invalid date format header.", H.BAD_REQUEST),
    "MalformedXML": ("The XML you provided was not well-formed or did not validate against our published schema.", H.BAD_REQUEST),
    "MethodNotAllowed": ("The specified method is not allowed against this resource.", H.METHOD_NOT_ALLOWED),
    "MissingContentLength": ("You must provide the Content-Length HTTP header.", H.LENGTH_REQUIRED),
    "NoSuchBucket": ("The specified bucket does not exist", H.NOT_FOUND),
    "NoSuchBucketPolicy": ("The bucket policy does not exist", H.NOT_FOUND),
    "NoSuchLifecycleConfiguration": ("The lifecycle configuration does not exist", H.NOT_FOUND),
    "AllAccessDisabled": ("All access to this bucket has been disabled.", H.FORBIDDEN),
    "MalformedPolicy": ("Policy has invalid resource.", H.BAD_REQUEST),
    "NoSuchKey": ("The specified key does not exist.", H.NOT_FOUND),
    "NoSuchUpload": ("The specified multipart upload does not exist.", H.NOT_FOUND),
    "NoSuchVersion": ("The specified version does not exist.", H.NOT_FOUND),
    "NotImplemented": ("A header you provided implies functionality that is not implemented", H.NOT_IMPLEMENTED),
    "PreconditionFailed": ("At least one of the pre-conditions you specified did not hold", H.PRECONDITION_FAILED),
    "RequestNotReadyYet": ("Request is not valid yet", H.FORBIDDEN),
    "RequestTimeTooSkewed": ("The difference between the request time and the server's time is too large.", H.FORBIDDEN),
    "SignatureDoesNotMatch": ("The request signature we calculated does not match the signature you provided.", H.FORBIDDEN),
    "SignatureVersionNotSupported": ("The authorization mechanism you have provided is not supported.", H.BAD_REQUEST),
    "ServerNotInitialized": ("Server not initialized, please try again.", H.SERVICE_UNAVAILABLE),
    "HealAlreadyRunning": ("Heal is already running on the given path", H.BAD_REQUEST),
    "HealOverlappingPaths": ("The heal path overlaps with a running heal sequence", H.BAD_REQUEST),
    "HealNoSuchProcess": ("No heal sequence exists on the given path", H.BAD_REQUEST),
    "HealInvalidClientToken": ("Client token mismatch for the heal sequence", H.BAD_REQUEST),
    "OperationTimedOut": ("A timeout occurred while trying to lock a resource, please reduce your request rate", H.SERVICE_UNAVAILABLE),
    "SlowDown": ("Resource requested is unreadable, please reduce your request rate", H.SERVICE_UNAVAILABLE),
    "XAmzContentSHA256Mismatch": ("The provided 'x-amz-content-sha256' header does not match what was computed.", H.BAD_REQUEST),
    "XAmzContentChecksumMismatch": ("The provided trailing checksum does not match what was computed.", H.BAD_REQUEST),
    "MalformedPOSTRequest": ("The body of your POST request is not well-formed multipart/form-data.", H.BAD_REQUEST),
    "AuthorizationHeaderMalformed": ("The authorization header is malformed.", H.BAD_REQUEST),
    "AuthorizationQueryParametersError": ("Query-string authentication parameters are malformed.", H.BAD_REQUEST),
    "NotModified": ("Not Modified", H.NOT_MODIFIED),
    # -- tagging (api-errors.go ErrBucketTaggingNotFound / ErrInvalidTag)
    "NoSuchTagSet": ("The TagSet does not exist", H.NOT_FOUND),
    "InvalidTag": ("The tag provided was not a valid tag. This error can occur if the tag did not pass input validation.", H.BAD_REQUEST),
    "InvalidTagDirective": ("Unknown tag directive.", H.BAD_REQUEST),
    # -- object lock / retention / legal hold (api-errors.go:171-181)
    "InvalidBucketObjectLockConfiguration": ("Bucket is missing ObjectLockConfiguration", H.BAD_REQUEST),
    "ObjectLockConfigurationNotFoundError": ("Object Lock configuration does not exist for this bucket", H.NOT_FOUND),
    "InvalidBucketState": ("Object Lock configuration cannot be enabled on existing buckets", H.CONFLICT),
    "NoSuchObjectLockConfiguration": ("The specified object does not have a ObjectLock configuration", H.BAD_REQUEST),
    "ObjectLocked": ("Object is WORM protected and cannot be overwritten", H.BAD_REQUEST),
    "InvalidRetentionDate": ("Date must be provided in ISO 8601 format", H.BAD_REQUEST),
    "PastObjectLockRetainDate": ("the retain until date must be in the future", H.BAD_REQUEST),
    "UnknownWORMModeDirective": ("unknown WORM mode directive", H.BAD_REQUEST),
    "ObjectLockInvalidHeaders": ("x-amz-object-lock-retain-until-date and x-amz-object-lock-mode must both be supplied", H.BAD_REQUEST),
    # -- bucket config long tail
    "ServerSideEncryptionConfigurationNotFoundError": ("The server side encryption configuration was not found", H.NOT_FOUND),
    "NoSuchCORSConfiguration": ("The CORS configuration does not exist", H.NOT_FOUND),
    "NoSuchWebsiteConfiguration": ("The specified bucket does not have a website configuration", H.NOT_FOUND),
    "ReplicationConfigurationNotFoundError": ("The replication configuration was not found", H.NOT_FOUND),
    "ReplicationDestinationNotFoundError": ("The replication destination bucket does not exist", H.NOT_FOUND),
    "ReplicationTargetNotVersionedError": ("The replication target does not have versioning enabled", H.BAD_REQUEST),
    "ReplicationSourceNotVersionedError": ("The replication source does not have versioning enabled", H.BAD_REQUEST),
    "XMinioAdminBucketQuotaExceeded": ("Bucket quota exceeded", H.BAD_REQUEST),
    "XMinioAdminNoSuchQuotaConfiguration": ("The quota configuration does not exist", H.NOT_FOUND),
    # -- misc request validation
    "InvalidStorageClass": ("Invalid storage class.", H.BAD_REQUEST),
    "InvalidPolicyDocument": ("The content of the form does not meet the conditions specified in the policy document.", H.BAD_REQUEST),
    "PolicyTooLarge": ("Policy exceeds the maximum allowed document size.", H.BAD_REQUEST),
    "MissingContentMD5": ("Missing required header for this request: Content-Md5.", H.BAD_REQUEST),
    "MissingSecurityHeader": ("Your request was missing a required header", H.BAD_REQUEST),
    "MissingRequestBodyError": ("Request body is empty.", H.LENGTH_REQUIRED),
    "InvalidObjectState": ("The operation is not valid for the current state of the object.", H.FORBIDDEN),
    "InvalidRegion": ("Region does not match.", H.BAD_REQUEST),
    "InvalidPrefixMarker": ("Invalid marker prefix combination", H.BAD_REQUEST),
    "BadRequest": ("400 BadRequest", H.BAD_REQUEST),
    "InvalidDuration": ("Duration provided in the request is invalid.", H.BAD_REQUEST),
    "InvalidTokenId": ("The security token included in the request is invalid", H.FORBIDDEN),
    "RequestTimeout": ("Your socket connection to the server was not read from or written to within the timeout period.", H.BAD_REQUEST),
    "UnsupportedNotification": ("MinIO server does not support Tilde, Period characters in prefix/suffix for notifications.", H.BAD_REQUEST),
    "XMinioInvalidObjectName": ("Object name contains unsupported characters.", H.BAD_REQUEST),
    "XMinioStorageFull": ("Storage backend has reached its minimum free disk threshold. Please delete a few objects to proceed.", H.INSUFFICIENT_STORAGE),
    "XMinioObjectTampered": ("The requested object was modified and may be compromised", H.PARTIAL_CONTENT),
    "XMinioBackendDown": ("Object storage backend is unreachable", H.SERVICE_UNAVAILABLE),
    # -- STS (cmd/sts-errors.go)
    "InvalidParameterValue": ("An invalid or out-of-range value was supplied for the input parameter.", H.BAD_REQUEST),
    "STSMissingParameter": ("A required parameter for the specified action is not supplied.", H.BAD_REQUEST),
    "STSInvalidClientTokenId": ("The security token included in the request is invalid.", H.FORBIDDEN),
    "STSAccessDenied": ("Generating temporary credentials not allowed for this request.", H.FORBIDDEN),
    "STSInternalError": ("We encountered an internal error generating credentials, please try again.", H.INTERNAL_SERVER_ERROR),
    # -- S3 Select (pkg/s3select errors surfaced through api-errors.go)
    "EmptyRequestBody": ("Request body cannot be empty.", H.BAD_REQUEST),
    "UnsupportedFunction": ("Encountered an unsupported SQL function.", H.BAD_REQUEST),
    "InvalidDataSource": ("Invalid data source type. Only CSV and JSON are supported at this time.", H.BAD_REQUEST),
    "InvalidExpressionType": ("The ExpressionType is invalid. Only SQL expressions are supported at this time.", H.BAD_REQUEST),
    "InvalidRequestParameter": ("The value of a parameter in SelectRequest element is invalid. Check the service API documentation and try again.", H.BAD_REQUEST),
    "InvalidFileHeaderInfo": ("The FileHeaderInfo is invalid. Only NONE, USE, and IGNORE are supported.", H.BAD_REQUEST),
    "InvalidQuoteFields": ("The QuoteFields is invalid. Only ALWAYS and ASNEEDED are supported.", H.BAD_REQUEST),
    "InvalidJsonType": ("The JsonType is invalid. Only DOCUMENT and LINES are supported at this time.", H.BAD_REQUEST),
    "InvalidCompressionFormat": ("The file is not in a supported compression format. Only GZIP and BZIP2 are supported.", H.BAD_REQUEST),
    "InvalidTextEncoding": ("Invalid encoding type. Only UTF-8 encoding is supported at this time.", H.BAD_REQUEST),
    "ParseSelectFailure": ("The SQL expression cannot be parsed.", H.BAD_REQUEST),
    "UnsupportedSqlOperation": ("Encountered an unsupported SQL operation.", H.BAD_REQUEST),
    "UnsupportedSqlStructure": ("Encountered an unsupported SQL structure. Check the SQL Reference.", H.BAD_REQUEST),
    "UnsupportedSyntax": ("Encountered invalid syntax.", H.BAD_REQUEST),
    "MissingRequiredParameter": ("The SelectRequest entity is missing a required parameter. Check the service documentation and try again.", H.BAD_REQUEST),
    # -- S3 Select SQL lexer/parser family (pkg/s3select/sql surfaced
    #    through api-errors.go); one code per distinguishable parse
    #    state so SDK retries/diagnostics behave like upstream
    "LexerInvalidChar": ("The SQL expression contains an invalid character.", H.BAD_REQUEST),
    "LexerInvalidOperator": ("The SQL expression contains an invalid operator.", H.BAD_REQUEST),
    "LexerInvalidLiteral": ("The SQL expression contains an invalid literal.", H.BAD_REQUEST),
    "ParseUnexpectedToken": ("The SQL expression contains an unexpected token.", H.BAD_REQUEST),
    "ParseUnexpectedKeyword": ("The SQL expression contains an unexpected keyword.", H.BAD_REQUEST),
    "ParseUnexpectedOperator": ("The SQL expression contains an unexpected operator.", H.BAD_REQUEST),
    "ParseUnexpectedTerm": ("The SQL expression contains an unexpected term.", H.BAD_REQUEST),
    "ParseExpectedExpression": ("Did not find the expected SQL expression.", H.BAD_REQUEST),
    "ParseExpectedKeyword": ("Did not find the expected keyword in the SQL expression.", H.BAD_REQUEST),
    "ParseExpectedTokenType": ("Did not find the expected token in the SQL expression.", H.BAD_REQUEST),
    "ParseExpectedNumber": ("Did not find the expected number in the SQL expression.", H.BAD_REQUEST),
    "ParseExpectedIdentForAlias": ("Did not find the expected identifier for the alias in the SQL expression.", H.BAD_REQUEST),
    "ParseExpectedArgumentDelimiter": ("Did not find the expected argument delimiter in the SQL expression.", H.BAD_REQUEST),
    "ParseEmptySelect": ("The SQL expression contains an empty SELECT.", H.BAD_REQUEST),
    "ParseSelectMissingFrom": ("The SQL expression contains a missing FROM after SELECT list.", H.BAD_REQUEST),
    "ParseExpectedMember": ("The SQL expression contains an invalid member reference.", H.BAD_REQUEST),
    "ParseAsteriskIsNotAloneInSelectList": ("Other expressions are not allowed in the SELECT list when '*' is used without dot notation in the SQL expression.", H.BAD_REQUEST),
    "ParseInvalidContextForWildcardInSelectList": ("Invalid use of '*' in the SELECT list of the SQL expression.", H.BAD_REQUEST),
    "ParseCastArity": ("The SQL expression CAST has incorrect arity.", H.BAD_REQUEST),
    "ParseExpectedLeftParenAfterCast": ("Did not find the expected left parenthesis after CAST in the SQL expression.", H.BAD_REQUEST),
    "ParseExpectedTypeName": ("Did not find the expected type name after CAST in the SQL expression.", H.BAD_REQUEST),
    "ParseInvalidTypeParam": ("The SQL expression contains an invalid parameter value for a type.", H.BAD_REQUEST),
    "ParseUnsupportedSyntax": ("The SQL expression contains unsupported syntax.", H.BAD_REQUEST),
    "ParseUnsupportedSelect": ("The SQL expression contains an unsupported use of SELECT.", H.BAD_REQUEST),
    "ParseUnsupportedCallWithStar": ("Only COUNT may be used with '*' in the SQL expression.", H.BAD_REQUEST),
    "ParseUnsupportedCase": ("The SQL expression contains an unsupported use of CASE.", H.BAD_REQUEST),
    "ParseUnsupportedLiteralsGroupBy": ("The SQL expression contains an unsupported use of GROUP BY.", H.BAD_REQUEST),
    "ParseUnsupportedAlias": ("The SQL expression contains an unsupported use of an alias.", H.BAD_REQUEST),
    "ParseUnknownOperator": ("The SQL expression contains an invalid operator.", H.BAD_REQUEST),
    "ParseMalformedJoin": ("JOIN is not supported in the SQL expression.", H.BAD_REQUEST),
    "ParseNonUnaryAgregateFunctionCall": ("Only one argument is supported for aggregate functions in the SQL expression.", H.BAD_REQUEST),
    "EvaluatorInvalidArguments": ("Incorrect number of arguments in the function call in the SQL expression.", H.BAD_REQUEST),
    "EvaluatorInvalidTimestampFormatPattern": ("The timestamp format pattern contains an invalid format specifier in the SQL expression.", H.BAD_REQUEST),
    "EvaluatorBindingDoesNotExist": ("A column name or a path provided does not exist in the SQL expression.", H.BAD_REQUEST),
    "InvalidCast": ("Attempt to convert from one data type to another using CAST failed in the SQL expression.", H.BAD_REQUEST),
    "CastFailed": ("Attempt to convert from one data type to another using CAST failed in the SQL expression.", H.BAD_REQUEST),
    "InvalidDataType": ("The SQL expression contains an invalid data type.", H.BAD_REQUEST),
    "InvalidColumnIndex": ("The column index in the SQL expression is invalid.", H.BAD_REQUEST),
    "InvalidKeyPath": ("The key path in the SQL expression is invalid.", H.BAD_REQUEST),
    "InvalidTableAlias": ("The SQL expression contains an invalid table alias.", H.BAD_REQUEST),
    "IntegerOverflow": ("An integer overflow or underflow occurred in the SQL expression.", H.BAD_REQUEST),
    "LikeInvalidInputs": ("Invalid argument given to the LIKE clause in the SQL expression.", H.BAD_REQUEST),
    "IllegalSqlFunctionArgument": ("Illegal argument was used in the SQL function.", H.BAD_REQUEST),
    "IncorrectSqlFunctionArgumentType": ("Incorrect type of arguments in the function call in the SQL expression.", H.BAD_REQUEST),
    "ExpressionTooLong": ("The SQL expression is too long: the maximum byte-length for the SQL expression is 256 KB.", H.BAD_REQUEST),
    "MissingHeaders": ("Some headers in the query are missing from the file. Check the file and try again.", H.BAD_REQUEST),
    "ValueParseFailure": ("Time stamp parse failure in the SQL expression.", H.BAD_REQUEST),
    "ObjectSerializationConflict": ("The SelectRequest entity contains more than one data serialization format.", H.BAD_REQUEST),
    # -- misc long-tail (api-errors.go)
    "UnsupportedRangeHeader": ("Range header type is not supported - only bytes ranges are accepted.", H.BAD_REQUEST),
    "UnauthorizedAccess": ("You are not authorized to perform this operation.", H.UNAUTHORIZED),
    "Busy": ("The service is unavailable, please retry.", H.SERVICE_UNAVAILABLE),
    "MissingFields": ("A required field in the request is missing.", H.BAD_REQUEST),
    "NoSuchBucketLifecycle": ("The bucket lifecycle configuration does not exist.", H.NOT_FOUND),
    "IllegalVersioningConfigurationException": ("The versioning configuration specified in the request is invalid.", H.BAD_REQUEST),
    "PostPolicyInvalidKeyName": ("Invalid according to Policy: Policy Condition failed.", H.FORBIDDEN),
    "AuthorizationParametersError": ("The authorization parameters in the request are invalid.", H.BAD_REQUEST),
}


# keys whose WIRE code differs from the key (matching the reference's
# Code strings exactly - mc/madmin/SDKs dispatch on these); the key
# names stay stable for in-tree raisers
_WIRE = {
    "SignatureVersionNotSupported": "InvalidRequest",
    "RequestNotReadyYet": "AccessDenied",
    "InvalidBucketObjectLockConfiguration": "InvalidRequest",
    "ObjectLocked": "InvalidRequest",
    "InvalidRetentionDate": "InvalidRequest",
    "PastObjectLockRetainDate": "InvalidRequest",
    "UnknownWORMModeDirective": "InvalidRequest",
    "ObjectLockInvalidHeaders": "InvalidRequest",
    "InvalidTagDirective": "InvalidArgument",
    "ServerNotInitialized": "XMinioServerNotInitialized",
    "OperationTimedOut": "RequestTimeout",
    "HealNoSuchProcess": "XMinioHealNoSuchProcess",
    "HealInvalidClientToken": "XMinioHealInvalidClientToken",
    "HealAlreadyRunning": "XMinioHealAlreadyRunning",
    "HealOverlappingPaths": "XMinioHealOverlappingPaths",
    "EvaluatorBindingDoesNotExist": "ErrEvaluatorBindingDoesNotExist",
}


def get(code: str, message: str = "") -> APIError:
    """APIError for a code key.  Keys are usually the wire code; the
    fine-grained reference conditions (ErrInvalidCopyDest, ...) that
    REUSE a wire code live in s3errors_table.VARIANTS under their
    internal names and resolve to (wire code, own message)."""
    hit = _E.get(code)
    if hit is not None:
        msg, status = hit
        return APIError(
            _WIRE.get(code, code), message or msg, int(status)
        )
    var = VARIANTS.get(code)
    if var is not None:
        wire, msg, status = var
        return APIError(wire, message or msg, int(status))
    msg, status = _E["InternalError"]
    return APIError(code, message or msg, int(status))


class S3Error(Exception):
    def __init__(self, code: str, message: str = ""):
        self.err = get(code, message)
        super().__init__(self.err.message)


def _lock_timeout():
    from ..dsync.namespace import LockTimeout

    return LockTimeout


def from_exception(e: Exception) -> APIError:
    """toAPIError: translate layer exceptions to S3 codes."""
    if isinstance(e, S3Error):
        return e.err
    if isinstance(e, AuthError):
        return get(e.code, str(e) if str(e) else "")
    if isinstance(e, NotImplementedError):
        # a feature this package has not ported yet: the message names
        # the slice that brings it
        return get("NotImplemented", str(e) or "")
    mapping = [
        (olapi.BucketNotFound, "NoSuchBucket"),
        (olapi.BucketExists, "BucketAlreadyOwnedByYou"),
        (olapi.BucketNotEmpty, "BucketNotEmpty"),
        (olapi.InvalidBucketName, "InvalidBucketName"),
        (olapi.ObjectNotFound, "NoSuchKey"),
        (olapi.VersionNotFound, "NoSuchVersion"),
        (olapi.InvalidObjectName, "KeyTooLongError"),
        (olapi.InvalidRange, "InvalidRange"),
        (olapi.ReadQuorumError, "SlowDown"),
        (olapi.WriteQuorumError, "SlowDown"),
        # lock quorum unavailable (dead peers) = service unavailable,
        # matching the reference's OperationTimedOut 503
        (_lock_timeout(), "OperationTimedOut"),
        (BadDigest, "BadDigest"),
        (SizeMismatch, "IncompleteBody"),
        (serrors.FileNotFound, "NoSuchKey"),
        (serrors.VolumeNotFound, "NoSuchBucket"),
    ]
    for cls, code in mapping:
        if isinstance(e, cls):
            if code in ("SlowDown", "OperationTimedOut"):
                # quorum/lock failures carry the per-disk cause; an
                # operator debugging a 503 needs it in the body
                return get(code, f"{_E[code][0]} ({e})")
            return get(code)
    return get("InternalError", f"{type(e).__name__}: {e}")
