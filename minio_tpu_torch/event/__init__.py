"""Bucket event notification core (pkg/event: event.go name masks,
rules.go; wired by cmd/notification.go).  The port carries the event
model, the rules and the notifier with its live listeners; notification
targets come in slice 9c (``targets.targets_from_env``)."""

from .event import Event, EventName, Identity  # noqa: F401
from .notifier import EventNotifier  # noqa: F401
from .rules import NotificationConfig, RulesMap  # noqa: F401
from .targets import targets_from_env  # noqa: F401
