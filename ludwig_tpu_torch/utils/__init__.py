"""The golden-log harness: fpdiff (the reference's log diff) and golden
(regression inputs through run_text against their committed logs)."""
