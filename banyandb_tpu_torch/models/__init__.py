"""Data-model engines: Measure, Stream, Trace, Property
(the reference's banyand/{measure,stream,trace,property} analogs)."""
