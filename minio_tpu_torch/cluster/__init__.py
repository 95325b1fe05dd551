"""Cluster topology and planes: drive endpoints (endpoints.py), the peer
control plane and bootstrap handshake (peer.py), federation's bucket DNS
(dns.py), and the multi-process loopback harness (harness.py)."""
