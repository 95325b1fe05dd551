"""Namespace-insensitive XML helpers shared by the S3 config document
parsers (tagging, object-lock, replication, SSE config)."""

from __future__ import annotations


def strip_ns(tag: str) -> str:
    return tag.rpartition("}")[2]


def findtext(root, name: str) -> str:
    """Text of the first *descendant* with the local name (documents
    where the name appears once, e.g. LegalHold/Status)."""
    for el in root.iter():
        if strip_ns(el.tag) == name:
            return (el.text or "").strip()
    return ""


def child_text(el, name: str) -> str:
    """Text of a *direct child* - for elements whose local name also
    appears nested deeper (e.g. Rule/Status vs
    Rule/DeleteMarkerReplication/Status)."""
    for c in el:
        if strip_ns(c.tag) == name:
            return (c.text or "").strip()
    return ""


def child(el, name: str):
    for c in el:
        if strip_ns(c.tag) == name:
            return c
    return None
