"""L3 — frame processors of the port (WIBEth) and the host plumbing they
use: error registry, typed non-blocking senders, the task pipeline."""
