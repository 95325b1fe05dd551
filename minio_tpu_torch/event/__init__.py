"""Bucket event notification (pkg/event: event.go name masks, rules.go,
targetlist.go; wired by cmd/notification.go and
cmd/bucket-notification-handlers.go).  The port carries the event
model, the rules, the notifier with its live listeners, and the
notification targets (webhook, log file, memory; Redis, NATS and Kafka
in ``brokers``) with the at-least-once queue store (``queuestore``)."""

from .event import Event, EventName, Identity  # noqa: F401
from .notifier import EventNotifier  # noqa: F401
from .rules import NotificationConfig, RulesMap  # noqa: F401
from .targets import (  # noqa: F401
    LogFileTarget,
    MemoryTarget,
    WebhookTarget,
    targets_from_env,
)
