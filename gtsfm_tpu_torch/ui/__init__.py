"""Pipeline introspection: process-graph generation (reference gtsfm/ui/)."""
