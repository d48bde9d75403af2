"""Mutable index structures layered over the frozen BAMG artifact (port
of `repro.index`).

`core` builds and serves *frozen* indexes; `serve` scales the read path.
This package holds the structures that make the corpus mutable while
those paths keep serving:

- `delta` -- streaming freshness: an in-memory insert graph + tombstone
  set over a frozen BAMG base (`DeltaLayer`), a unified base+delta
  searcher (`FreshBAMGEngine`), background consolidation back into a
  full block-aware build (`consolidate`), and the read-write service
  facade that publishes consolidated builds through the blue/green
  deployment lifecycle (`FreshService`).
"""
from .delta import (DeltaLayer, DeltaParams, FreshBAMGEngine,  # noqa: F401
                    FreshService, consolidate)
