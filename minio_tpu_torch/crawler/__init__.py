"""Data crawler: usage accounting, lifecycle expiry, FIFO quota eviction
and heal-on-crawl (cmd/data-crawler.go, cmd/data-usage.go), with the
data-update tracker whose bloom journal lets a sweep skip clean buckets
(updatetracker.py)."""

from .crawler import DataCrawler, DataUsage  # noqa: F401
