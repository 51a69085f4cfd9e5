"""Part of the olap_bench benchmark; see olap_bench/__init__.py."""
