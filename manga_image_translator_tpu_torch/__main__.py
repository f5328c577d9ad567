"""CLI entry point (contract: reference manga_translator/__main__.py —
dispatch to local/ws/shared/config-help modes)."""
from __future__ import annotations

import asyncio
import json
import sys

from .args import parser
from .utils.log import get_logger, init_logging

logger = get_logger('main')


async def dispatch(args):
    args_dict = vars(args)
    logger.info(f'Running in {args.mode} mode')
    if args.mode == 'local':
        from .mode.local import MangaTranslatorLocal
        translator = MangaTranslatorLocal(args_dict)
        dest = args_dict.get('dest', '')
        await translator.translate_path(args_dict['input'], dest, args_dict)
    elif args.mode == 'shared':
        from .mode.share import MangaShare
        share = MangaShare(args_dict)
        await share.listen(args_dict)
    elif args.mode == 'ws':
        from .mode.ws import MangaTranslatorWS
        translator = MangaTranslatorWS(args_dict)
        await translator.listen(args_dict)
    elif args.mode == 'config-help':
        from .config import Config
        print(json.dumps(Config.model_json_schema(), indent=2))


def main():
    args, _unknown = parser.parse_known_args()
    init_logging(getattr(args, 'verbose', False))
    try:
        asyncio.run(dispatch(args))
    except KeyboardInterrupt:
        print()
        sys.exit(1)


if __name__ == '__main__':
    main()
