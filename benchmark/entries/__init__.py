"""The entry points the window drives, one module each: ``corpus``
(``Tekkenizer.encode_batch``).  A configuration names its entry."""
