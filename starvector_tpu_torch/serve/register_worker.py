"""Register a worker with the controller by hand (port of
starvector_tpu/serve/register_worker.py; reference:
starvector/serve/register_worker.py:12-26), on urllib.

    python -m starvector_tpu_torch.serve.register_worker \
        --controller-address http://localhost:21001 --worker-name http://localhost:21002
"""

import argparse

from starvector_tpu_torch.serve.httpd import post_json_reply


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--controller-address", required=True)
    parser.add_argument("--worker-name", required=True)
    parser.add_argument("--check-heart-beat", action="store_true")
    args = parser.parse_args(argv)
    status = post_json_reply(args.worker_name + "/worker_get_status", {}, timeout=10)
    reply = post_json_reply(args.controller_address + "/register_worker",
                            {"worker_name": args.worker_name,
                             "check_heart_beat": args.check_heart_beat,
                             "worker_status": status}, timeout=10)
    if not reply.get("exist"):
        raise SystemExit(f"the controller did not register {args.worker_name}: {reply}")
    print("registered:", args.worker_name)


if __name__ == "__main__":
    main()
